"""Cells of the benchmark cut to a size a CPU test can hold: the same
model code and traffic generator at tiny widths, few triangles and small
images.  Only tests use these; the benchmark's cells are never cut."""

from __future__ import annotations

import dataclasses

from rfbench import registry

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4, view_transformer_latent_dim=72,
            view_transformer_ffn_hidden_dim=144, view_transformer_n_heads=2,
            view_transformer_n_layers=4, dpt_features=16, dpt_out_channels=[8, 16, 32, 64])


def tiny_model(cell_model: dict) -> dict:
    return dict(cell_model, **TINY)


def tiny_cell(name: str):
    """The cell ``name`` with a tiny model and small traffic."""
    cell = registry.load(name)
    model = tiny_model(cell.model)
    swin = model['view_transformer_use_swin_attn']
    if cell.mix['kind'] == 'render':
        mix = dict(cell.mix, resolution=128 if swin else 64, triangles=[30, 40, 50], views=2)
    else:
        mix = dict(cell.mix, resolution=128, triangles=[30, 40, 50, 60], pad_to=64,
                   max_steps=64)
    return dataclasses.replace(cell, config=dict(cell.config, model=model), mix=mix)
