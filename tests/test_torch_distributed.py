"""The port in a two-process gloo group (tests/test_torch_distributed_worker.py)
against the port in one process, at the tiny config of
tests/test_sharding.py: sharded renders (the scenes over ``data``, the
attention sites over ``seq`` by ring and by sequence-split attention)
against the unsharded render, and one epoch of the trainer, data-parallel
over the two ranks, against one process on the same global batches (the
counterparts of tests/test_sharding.py and tests/test_distributed.py).
Rank 0 alone writes the checkpoints."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_distributed_worker as worker  # noqa: E402


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('group'))
    worker.memory_dataset(root)  # the ground-truth PNGs, before the ranks read them
    ranks, logs = worker.run_group('model', root)
    return root, ranks, logs


@pytest.fixture(scope='module')
def single(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('single'))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        return worker.fit(root, os.path.join(root, 'ckpt'))
    finally:
        torch.set_num_threads(threads)


# (triangles a scene, [ring calls, sequence-split calls] in one render)
SHARDED = {'data2': (8, [0, 0]),     # (2, 1): the scenes over data, no seq split
           'ring2': (8, [10, 0]),    # (1, 2): 2 triangle self sites, 4 cross, 4 ray self
           'split2': (7, [4, 4])}    # 11 tokens: triangle sites whole, cross split


@pytest.mark.parametrize('name', ['data2', 'ring2', 'split2'])
def test_sharded_render_matches_unsharded(group, name):
    _, ranks, _ = group
    n_tris, calls = SHARDED[name]
    for r in ranks:
        assert r[name].shape == (2, 2, worker.RES, worker.RES, 3)
        np.testing.assert_allclose(r[name], r[f'unsharded/{n_tris}'], atol=2e-5, rtol=1e-4)
        assert r[f'calls/{name}'].tolist() == calls
    # the image is all-gathered: every rank holds the same one
    np.testing.assert_array_equal(ranks[0][name], ranks[1][name])


def test_gspmd_notice_is_printed_once(group):
    _, _, logs = group
    for log in logs:
        assert log.count('everything outside the attention sites is computed whole') == 2
        # the 11-token sites fall back from the ring, each shape said once
        assert log.count('NOTICE: attention shapes') == 2


def test_two_process_fit_matches_one_process(group, single):
    _, ranks, _ = group
    init = {n: p.detach().numpy() for n, p in worker.init_model().named_parameters()}
    for r in ranks:
        np.testing.assert_allclose(r['fit/loss'], [m['loss'] for m in single.step_metrics],
                                   rtol=1e-5)
        np.testing.assert_allclose(r['fit/grad_norm'],
                                   [m['grad_norm'] for m in single.step_metrics], rtol=1e-4)
        np.testing.assert_allclose(r['fit/val'], single.val_losses, rtol=1e-5)
        moved = 0.0
        for n, p in single.model.named_parameters():
            np.testing.assert_allclose(r[f'param/{n}'], p.detach().numpy(), atol=1e-6,
                                       rtol=1e-4, err_msg=n)
            moved = max(moved, float(np.abs(r[f'param/{n}'] - init[n]).max()))
        assert moved > 1e-5  # three steps of the 5e-6 learning rate moved them
    # the ranks took the same decisions on the same numbers
    for key in ranks[0]:
        if key.startswith(('fit/', 'param/')):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)


def test_rank_0_alone_writes_checkpoints(group):
    root, _, _ = group
    writes = [json.load(open(os.path.join(root, f'writes_rank{r}.json'))) for r in range(2)]
    assert writes[0]['mesh'] == writes[1]['mesh'] == [2, 1]
    assert sorted(writes[0]['writes']) == ['best', 'epoch_0', 'final']
    assert writes[1]['writes'] == []
    assert sorted(os.listdir(os.path.join(root, 'ckpt'))) == ['best', 'epoch_0', 'final',
                                                             'runs']
