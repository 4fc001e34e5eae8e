"""One-command verification of a RenderFormer checkpoint (the JAX package's
``tools/verify_checkpoint.py``), ready for the released
``microsoft/renderformer-v1-base`` / ``v1.1-swin-large`` weights once they
are on disk.

    python -m renderformer_tpu_torch.tools.verify_checkpoint --checkpoint DIR \
        [--h5_file scene.h5] [--resolution 256] [--precision fp32] \
        [--torch_compare --reference_root UPSTREAM_DIR] [--golden_exr ref.exr] \
        [--save_exr out.exr] [--cpu]

DIR is an HF directory (``config.json`` + ``model.safetensors``, as
downloaded) or a directory that either package's ``export_params`` wrote.
Checks, in order:
  1. the load: ``RenderingPipeline.from_pretrained``, the config, and the
     parameter count of the JAX tree, the RoPE buffers included;
  2. a finite render of a seeded random scene (or ``--h5_file``, read by
     the port's ``io/hdf5``);
  3. with ``--torch_compare``, the raw model against the upstream PyTorch
     ``renderformer`` (on the CPU) on the same weights and inputs, fp32
     (max|err| and PSNR, >= 60 dB); the upstream package is imported from
     ``--reference_root`` (or ``$RENDERFORMER_REFERENCE_ROOT``) and the
     step fails where it is not there;
  4. with ``--golden_exr``, the render's PSNR against that image (> 30 dB).
Exit code 0 when every step run passed, else 1.  On the card unless given
``--cpu``.
"""

import argparse
import os
import sys
import types

import numpy as np

from renderformer_tpu_torch.io import hdf5


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    peak = float(max(b.max() - b.min(), 1e-9))
    return 10 * np.log10(peak ** 2 / max(mse, 1e-20))


def load_scene(h5_file):
    with hdf5.File(h5_file, 'r') as f:
        return dict(
            triangles=f['triangles'][:][None],
            texture=f['texture'][:].astype(np.float32)[None],
            mask=np.ones((1, f['triangles'].shape[0]), bool),
            vn=f['vn'][:][None],
            c2w=f['c2w'][:][None],
            fov=f['fov'][:][None, :, None],
        )


def random_scene(n=256, v=1, seed=0):
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    c2w[..., 2, 3] = 2.0
    return dict(
        triangles=rng.normal(size=(1, n, 3, 3)).astype(np.float32) * 0.3,
        texture=rng.uniform(0, 1, (1, n, 13, 32, 32)).astype(np.float32),
        mask=np.ones((1, n), bool),
        vn=rng.normal(size=(1, n, 3, 3)).astype(np.float32),
        c2w=c2w,
        fov=np.full((1, v, 1), 40.0, np.float32),
    )


def param_count(model) -> int:
    """Elements of the JAX tree the model's state_dict converts to: every
    parameter and the RoPE frequency buffers (the JAX ``param_count``)."""
    return sum(v.numel() for v in model.state_dict().values())


def import_upstream(root):
    """The upstream PyTorch ``renderformer`` package from the checkout at
    ``root``, with its optional ``roma`` dependency stubbed (used only by a
    function this check never calls) and its attention set to SDPA."""
    if not root or not os.path.isdir(os.path.join(root, 'renderformer')):
        raise ImportError(f'no upstream renderformer package under {root!r}: pass '
                          f'--reference_root DIR (a checkout of the reference implementation)')
    if root not in sys.path:
        sys.path.append(root)
    sys.modules.setdefault('roma', types.ModuleType('roma'))
    os.environ.setdefault('ATTN_IMPL', 'sdpa')
    import renderformer  # noqa: F401
    return renderformer


def _patched(rays_d, p):
    """[b, v, H, W, 3] directions -> the view transformer's patch layout
    [b, v, (H/p)(W/p), 3*p*p] (``utils/rays.generate_rays_patched``)."""
    b, v, h, w, _ = rays_d.shape
    x = rays_d.reshape(b, v, h // p, p, w // p, p, 3).permute(0, 1, 2, 4, 6, 3, 5)
    return x.reshape(b, v, (h // p) * (w // p), 3 * p * p)


def parity_inputs(resolution):
    """Step 3's raw model inputs, the JAX tool's (numpy seed 1, 64
    triangles, one view): tri_vpos [1, 64, 9], texture, mask, vns, rays_o
    [1, 1, 3], rays_d [1, 1, res, res, 3] (the upstream layout), tri_view."""
    r = random_scene(n=64, seed=1)
    b, n = 1, 64
    rng = np.random.default_rng(1)
    rays_o = rng.normal(size=(b, 1, 3)).astype(np.float32)
    rays_d = rng.normal(size=(b, 1, resolution, resolution, 3)).astype(np.float32)
    tri_view = rng.normal(size=(b, 1, n, 9)).astype(np.float32) * 0.3
    return (r['triangles'].reshape(b, n, 9), r['texture'], r['mask'],
            r['vn'].reshape(b, n, 9), rays_o, rays_d, tri_view)


def port_output(pipe, inputs):
    """The port's raw fp32 model on ``inputs`` (rays_d put in its patch
    layout unless the config encodes view directions), as the upstream
    model returns it: [b, v, 3, H, W] on the CPU."""
    import torch
    args = [torch.from_numpy(x) for x in inputs]
    if pipe.config.vdir_num_freqs == 0:
        args[5] = _patched(args[5], pipe.config.patch_size)
    with torch.no_grad():
        got = pipe.model(*(a.to(pipe.device) for a in args)).float().cpu().numpy()
    return np.transpose(got, (0, 1, 4, 2, 3))


def torch_parity(pipe, checkpoint, resolution, reference_root):
    """Step 3: (max|err|, PSNR) of the port's raw fp32 model on its device
    against the upstream model on the CPU, the same weights, the same
    inputs."""
    import torch
    from renderformer_tpu_torch.io.safetensors import load_file
    import_upstream(reference_root)
    from renderformer.models.config import RenderFormerConfig as TC
    from renderformer.models.renderformer import RenderFormer as TRF
    tmodel = TRF(TC(**pipe.config.to_dict())).eval()
    tmodel.load_state_dict(load_file(os.path.join(checkpoint, 'model.safetensors')),
                           strict=True)
    inputs = parity_inputs(resolution)
    with torch.no_grad():
        want = tmodel(*(torch.from_numpy(x) for x in inputs)).numpy()
    got = port_output(pipe, inputs)
    return float(np.abs(got - want).max()), psnr(got, want)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--checkpoint', required=True,
                    help='HF-format dir (config.json + model.safetensors) '
                         'or a dir written by export_params')
    ap.add_argument('--h5_file', default=None)
    ap.add_argument('--resolution', type=int, default=256)
    ap.add_argument('--precision', default='fp32', choices=['fp32', 'bf16', 'fp16'])
    ap.add_argument('--torch_compare', action='store_true',
                    help='also run the upstream PyTorch model with the same weights on '
                         'the CPU and compare (needs --reference_root)')
    ap.add_argument('--reference_root',
                    default=os.environ.get('RENDERFORMER_REFERENCE_ROOT', ''),
                    help='checkout of the reference implementation (holds renderformer/)')
    ap.add_argument('--golden_exr', default=None, help='reference EXR to PSNR against')
    ap.add_argument('--save_exr', default=None)
    ap.add_argument('--cpu', action='store_true')
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from renderformer_tpu_torch.pipelines.rendering_pipeline import RenderingPipeline

    # 1. load path ------------------------------------------------------
    pipe = RenderingPipeline.from_pretrained(args.checkpoint,
                                             device='cpu' if args.cpu else None)
    cfg = pipe.config
    n_params = param_count(pipe.model)
    print(f'[1/4] loaded {args.checkpoint}')
    print(f'      latent_dim={cfg.latent_dim} layers={cfg.num_layers}'
          f'/{cfg.view_transformer_n_layers}'
          f' swin={cfg.view_transformer_use_swin_attn}')
    print(f'      params: {n_params / 1e6:.1f}M (incl. rope buffers)')

    # 2. render smoke ---------------------------------------------------
    scene = load_scene(args.h5_file) if args.h5_file else random_scene()
    img = pipe.render(scene['triangles'], scene['texture'], scene['mask'], scene['vn'],
                      scene['c2w'], scene['fov'], resolution=args.resolution,
                      precision=args.precision).float().cpu().numpy()
    finite = np.isfinite(img).all()
    print(f'[2/4] render {img.shape} {args.precision}: '
          f'finite={finite} range=[{img.min():.4f}, {img.max():.4f}]')
    if not finite:
        print('FAIL: non-finite pixels')
        return 1
    if args.save_exr:
        from renderformer_tpu_torch.io.image import write_exr
        write_exr(args.save_exr, img[0, 0])
        print(f'      wrote {args.save_exr}')

    # 3. torch parity ---------------------------------------------------
    if args.torch_compare:
        err, p = torch_parity(pipe, args.checkpoint, args.resolution, args.reference_root)
        print(f'[3/4] torch parity: max|err|={err:.3e} PSNR={p:.1f} dB')
        if p < 60:
            print('FAIL: parity below 60 dB')
            return 1
    else:
        print('[3/4] torch parity: skipped (--torch_compare not set)')

    # 4. golden image ---------------------------------------------------
    if args.golden_exr:
        from renderformer_tpu_torch.io.image import read_exr
        ref = read_exr(args.golden_exr)
        p = psnr(img[0, 0], ref)
        print(f'[4/4] golden EXR PSNR: {p:.2f} dB '
              f'({"OK" if p > 30 else "FAIL"} at the >30dB bf16 gate)')
        if p <= 30:
            return 1
    else:
        print('[4/4] golden EXR: skipped (--golden_exr not set)')

    print('checkpoint verified OK')
    return 0


if __name__ == '__main__':
    sys.exit(main())
