"""The port's workflow tools, the JAX package's ``tools/``: each runs as
``python -m renderformer_tpu_torch.tools.<name>``, and those that use a
device run on ``cuda`` unless given ``--cpu``."""
