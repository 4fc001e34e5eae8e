"""Rays of every render whose image reached the host, or trained rays
(ground-truth pixels supervised) of every step finished, in the window,
over the window's seconds (from its start to the last result back)."""


def read(run):
    recs = [r for r in run.window['records'] if r['ok']]
    return sum(r['rays'] for r in recs) / (run.window['t_end'] - run.window['t0'])
