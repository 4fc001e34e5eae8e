"""The window's model FLOPs (rfbench/counts.py: a render's forward pass, a
train step's three forward passes with remat not counted, at real triangle
counts) over the window's seconds, as a share of the card's dense bf16
peak, whatever precision a stage runs in."""

from rfbench.counts import PEAK_BF16


def read(run):
    flops = sum(r['flops'] for r in run.window['records'] if r['ok'])
    return 100.0 * flops / (run.window['t_end'] - run.window['t0']) / PEAK_BF16
