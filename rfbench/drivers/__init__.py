"""The drivers of the traffic kinds: ``render`` (a client of
``RenderingPipeline.render``) and ``train`` (the fine-tuning step).

A driver module has ``Driver(cell, seed, device)`` with ``setup()``,
``window(seconds)``, ``tail()`` (a short run of the same work, to be
profiled) and ``judge(controls=())``, and ``attempted``/``failed`` counts.
"""
