"""Which ops of the port's train step give other bits in a second call, on
one GPU.

    python3 tools/torch_determinism_probe.py

``TrainConfig(deterministic=True)`` promises the same bits on every run.
This probe shows, op by op at the train steps' sizes, what that rests on:

  * conv3x3: the DPT head's 3x3 convolution, fp32, channels-last, 128
    channels, at the 32^2 to 256^2 sizes of its refinenets: whether two
    calls of autograd give the same input and weight gradients with
    ``torch.backends.cudnn.deterministic`` off and on;
  * lerp: the DPT tail's border lerp (``ops/fused_resize.py:resize_axis``,
    256 -> 512 and 128 -> 256 along one axis of a [B, n, 128] border strip)
    whether its VJPs agree, through autograd of the lerp written with
    ``index_select`` (whose VJP adds a repeated index's terms by atomics)
    and through the port's VJP (one product with the transposed resize
    matrix), over CALLS calls: how many give the first call's bits.

Prints the card's nvidia-smi line, then one JSON line a case with the
largest difference from the first call.
"""

import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from renderformer_tpu_torch.ops.fused_resize import _lerp_axis, resize_axis  # noqa: E402


CALLS = 10


def differ(a, b):
    """Largest absolute difference of two tuples of tensors, elementwise."""
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def conv_grads(x, w, gy):
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = F.conv2d(xl.permute(0, 3, 1, 2), wl, padding=1)
    return torch.autograd.grad(y, (xl, wl), gy)


def main():
    if not torch.cuda.is_available():
        sys.exit('no CUDA device: this probe needs one GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    c = 128
    for n in (32, 64, 128, 256):
        x, w = randn(1, n, n, c), randn(c, c, 3, 3)
        gy = randn(1, c, n, n).contiguous(memory_format=torch.channels_last)
        for det in (False, True):
            prev = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = det
            try:
                a, b = conv_grads(x, w, gy), conv_grads(x, w, gy)
            finally:
                torch.backends.cudnn.deterministic = prev
            torch.cuda.synchronize()
            print(json.dumps({'case': 'conv3x3', 'size': n, 'channels': c,
                              'cudnn_deterministic': det,
                              'dx_same': bool(torch.equal(a[0], b[0])),
                              'dw_same': bool(torch.equal(a[1], b[1])),
                              'max_diff': differ(a, b)}), flush=True)

    for n_in, n_out in ((128, 256), (256, 512)):
        x, g = randn(1, n_in, c), randn(1, n_out, c)
        for name, fn in (('index_select', _lerp_axis), ('port', resize_axis)):
            grads = []
            for _ in range(CALLS):
                xl = x.clone().requires_grad_(True)
                grads.append(torch.autograd.grad(fn(xl, 1, n_out), xl, g))
            torch.cuda.synchronize()
            print(json.dumps({'case': 'lerp', 'n_in': n_in, 'n_out': n_out, 'vjp': name,
                              'calls': CALLS,
                              'same_as_first': sum(torch.equal(r[0], grads[0][0])
                                                   for r in grads[1:]),
                              'max_diff': max(differ(r, grads[0]) for r in grads[1:])}),
                  flush=True)


if __name__ == '__main__':
    main()
