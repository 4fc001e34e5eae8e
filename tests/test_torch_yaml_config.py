"""The port's YAML reader (``renderformer_tpu_torch/utils/yaml_config.py``)
against ``yaml.safe_load``, which is only the reference here: every config
of the repo and generated block mappings load to the same values of the
same types, input outside the subset raises with its line, and
``python -m renderformer_tpu_torch.train -c`` fine-tunes from a YAML file
and H5 scenes with h5py and PyYAML unimportable."""

import glob
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from renderformer_tpu_torch import RenderFormerConfig
from renderformer_tpu_torch.io.h5 import save_scene_h5
from renderformer_tpu_torch.io.image import write_png
from renderformer_tpu_torch.models.renderformer import RenderFormer
from renderformer_tpu_torch.nn.core import init_weights
from renderformer_tpu_torch.training.checkpoint import export_params
from renderformer_tpu_torch.utils import yaml_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(a, b) -> bool:
    """Equal values of the same types, dict keys in the same order."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize('path', sorted(glob.glob(os.path.join(REPO, 'configs', '*.yml'))),
                         ids=os.path.basename)
def test_repo_configs_load_as_safe_load(path):
    got = yaml_config.load_file(path)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert same(got, want), (got, want)
    # config.yml's learning rate stays the string train.py's float() reads
    assert got['training']['learning_rate'] == '5e-6'


# the resolver's edge cases, as written in a file
EDGES = ['5e-6', '1.0e+4', '1.0e4', '0x1F', '-0x1f', '1_000', '017', '0o17', '0b101', '1:30',
         '1.5:30', '+12', '.5', '1.', '-.5e+3', '12_3.4_5', '.inf', '-.Inf', '.NaN', 'Yes',
         'NO', 'on', 'Off', 'TRUE', 'y', '~', 'null', 'Null', 'NULL', "'quoted: #'",
         "'it''s'", "''", '""', '"tab\\there # not a comment"', '"\\u00e9\\x41"', 'a#b',
         'http://x.y/z', 'a:b', 'v1-base', 'datasets/ft128/h5']
WORD = st.from_regex(r'[a-zA-Z_][a-zA-Z0-9_./-]{0,10}', fullmatch=True)
TEXT = st.text(alphabet=st.sampled_from(list(' abcxyz019:#,-[]{}!&*%@|>é') + ['\t']),
               max_size=10)
PLAIN = st.one_of(st.sampled_from([e for e in EDGES if e[0] not in '\'"']), WORD,
                  st.integers(-10 ** 12, 10 ** 12).map(str),
                  st.floats(allow_nan=False, allow_infinity=False).map(repr))
QUOTED = st.one_of(TEXT.map(lambda s: "'" + s.replace("'", "''") + "'"),
                   TEXT.map(lambda s: '"' + s.replace('\\', '\\\\').replace('"', '\\"') + '"'),
                   st.sampled_from([e for e in EDGES if e[0] in '\'"']))
SCALAR = st.one_of(PLAIN, QUOTED)
# flow items: no ':' or ',' that the flow context would split on
FLOW_ITEM = st.one_of(st.sampled_from(['5e-6', '0x1F', '1_000', 'Yes', '~', "'a, b'", '1.5',
                                       '-7', 'word']), st.integers(-999, 999).map(str), WORD)
KEY = st.one_of(st.from_regex(r'[a-z_][a-z0-9_]{0,6}', fullmatch=True),
                st.sampled_from(['yes', 'on', '1', '0x10', 'null', "'quoted key'", '"k: v"']))
COMMENT = st.sampled_from(['', ' # a comment', '   #'])


def _node(depth):
    leaf = st.one_of(
        st.tuples(st.just('scalar'), SCALAR, COMMENT),
        st.tuples(st.just('flow'), st.lists(FLOW_ITEM, max_size=4), COMMENT),
        st.tuples(st.just('seq'), st.lists(SCALAR, min_size=1, max_size=3), st.booleans()),
        st.tuples(st.just('empty'), COMMENT, COMMENT))
    if depth == 0:
        return leaf
    return st.one_of(leaf, st.tuples(st.just('map'),
                                     st.lists(st.tuples(KEY, _node(depth - 1)), min_size=1,
                                              max_size=4), st.integers(1, 4)))


def _dump(entries, indent, lines):
    """Lines of a block mapping of ``entries`` at ``indent``."""
    pad = ' ' * indent
    for key, (kind, a, b) in entries:
        if kind == 'scalar':
            lines.append(f'{pad}{key}: {a}{b}')
        elif kind == 'flow':
            lines.append(f'{pad}{key}: [{", ".join(a)}]{b}')
        elif kind == 'empty':
            lines.append(f'{pad}{key}:{a}')
        elif kind == 'seq':   # b: the items in the key's own column, or indented
            lines.append(f'{pad}{key}:')
            lines += [f'{pad}{"" if b else "  "}- {x}' for x in a]
        else:
            lines.append(f'{pad}{key}:')
            if b == 4:
                lines.append('')   # a blank line inside a block
            _dump(a, indent + b, lines)
    return lines


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(KEY, _node(2)), min_size=1, max_size=5),
       st.sampled_from(['', '# a leading comment\n', '---\n']))
def test_generated_block_mappings_load_as_safe_load(entries, head):
    text = head + '\n'.join(_dump(entries, 0, [])) + '\n'
    want = yaml.safe_load(text)
    got = yaml_config.load(text)
    assert same(got, want), (text, got, want)


@pytest.mark.parametrize('text, line, what', [
    ('a: 1\nb: &anchor 2\n', 2, 'anchor'),
    ('a:\n  b: *alias\n', 2, 'alias'),
    ('a: !!int 3\n', 1, 'tag'),
    ('a: 1\nb: |\n  text\n', 2, 'block scalar'),
    ('a: {b: 1}\n', 1, 'flow mapping'),
    ('a: 1\n---\nb: 2\n', 2, 'second document'),
    ('a: 1\n...\n', 2, 'document end'),
    ('%YAML 1.1\n---\na: 1\n', 1, 'directive'),
    ('a:\n  - x\n  - y: 1\n', 3, 'mapping inside a block sequence'),
    ('a: 2024-01-01\n', 1, 'timestamp'),
    ('? complex\n: key\n', 1, 'key: value'),
    ('a: b: c\n', 1, 'mapping in a value'),
    ('a: 1\n  continued\n', 2, 'scalar over lines'),
    ('a: "open\n', 1, 'does not close'),
    ('a: [1, 2\n', 1, 'does not close'),
    ('a:\n    b: 1\n  c: 2\n', 3, 'indentation'),
    ('<<: 1\n', 1, 'merge'),
])
def test_outside_the_subset_raises_with_its_line(text, line, what):
    with pytest.raises(ValueError, match=rf'^line {line}: .*{what}'):
        yaml_config.load(text)


TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
# a GPU machine may have none of these; TensorBoard's import would pull
# TensorFlow in here
_BLOCKED = r'''
import runpy, sys
class _Absent:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('h5py', 'yaml', 'tensorboard'):
            raise ImportError(f'{name} made unimportable')
        return None
sys.meta_path.insert(0, _Absent())
sys.argv = ['train'] + sys.argv[1:]
try:
    runpy.run_module('renderformer_tpu_torch.train', run_name='__main__')
finally:
    bad = sorted(m for m in sys.modules if m.split('.')[0] in ('h5py', 'yaml', 'jax'))
    assert not bad, bad
'''


def test_train_cli_runs_from_yaml_and_h5_without_h5py_or_yaml(tmp_path):
    data = tmp_path / 'data'
    rng = np.random.default_rng(0)
    mask = np.add.outer(np.arange(32), np.arange(32)) <= 32
    for i, n in enumerate((10, 14)):
        flat = rng.uniform(0, 1, (n, 13, 1, 1)).astype(np.float16).astype(np.float32)
        c2w = np.eye(4, dtype=np.float32)[None]
        c2w[:, 2, 3] = 2.0
        save_scene_h5(str(data / f'scene_{i}.h5'),
                      triangles=rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.3,
                      vn=rng.normal(size=(n, 3, 3)).astype(np.float32), texture=flat * mask,
                      c2w=c2w, fov=np.full((1,), 40.0, np.float32))
        write_png(str(data / f'scene_{i}.png'), rng.integers(0, 256, (32, 32, 3), np.uint8))
    model = init_weights(RenderFormer(RenderFormerConfig(**TINY)),
                         torch.Generator().manual_seed(0))
    export_params(str(tmp_path / 'model'), model, model.config)
    ckpt = tmp_path / 'ckpt'
    (tmp_path / 'config.yml').write_text(f'''# a one-epoch fine-tune of the tiny model
training:
  num_epochs: 1
  learning_rate: 1e-4      # a string to YAML 1.1, as in configs/config.yml
  weight_decay: 1.0e-4
  max_grad_norm: 1.0
  batch_size: 1

data:
  h5_dir: "{data}"
  gt_dir: '{data}'
  max_resolution: 32
  train_val_split: 0.5

model:
  model_id: {tmp_path / 'model'}

output:
  checkpoint_dir: {ckpt}
  log_dir: {tmp_path / 'runs'}
  save_interval: 1

memory:
  autocast_dtype: float32
  use_gradient_checkpointing: yes
''')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    res = subprocess.run([sys.executable, '-c', _BLOCKED, '-c', str(tmp_path / 'config.yml'),
                          '--cpu'], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'final train losses' in res.stdout, res.stdout
    for tag in ('best', 'epoch_0', 'final'):
        assert (ckpt / tag / 'state.pt').exists(), tag
    with open(ckpt / 'final' / 'renderformer_meta.json') as f:
        extra = json.load(f)['extra']
    assert len(extra['train_losses']) == len(extra['val_losses']) == 1
    assert np.isfinite(extra['train_losses'] + extra['val_losses']).all(), extra
