"""Compare the SASS of kernels between two builds of the port's kernel library.

    python3 tools/sass_diff.py OLD.so NEW.so NAME [NAME ...] [--show]

For each NAME, every kernel function whose mangled name holds it is taken
from ``cuobjdump -sass`` of both libraries and compared instruction for
instruction, with the instruction addresses and encodings left out and the
per-build hash of the anonymous namespace taken out of the names.  Prints,
for each NAME, how many functions each build has and how many are
identical; ``--show`` prints the differing lines of each function that
differs.  Build the libraries with ``renderformer_tpu_torch._build.build()``
in each tree (needs the CUDA toolkit).
"""

import argparse
import difflib
import re
import shutil
import subprocess

# _ZN<len>_GLOBAL__N__<hash>_<len>_<file>_cu_<hash>: the anonymous namespace
ANON = re.compile(r'_ZN\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}')


def functions(lib):
    """{kernel name without the anonymous namespace: [instructions]}."""
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    out = subprocess.run([cuobjdump, '-sass', lib], capture_output=True, text=True,
                         check=True).stdout
    res, cur = {}, None
    for line in out.splitlines():
        if 'Function :' in line:
            cur = ANON.sub('_ZN', line.split('Function :', 1)[1].strip())
            res[cur] = []
        elif cur is not None and '/*' in line:
            ins = re.sub(r'/\*[0-9a-f]{4,}\*/', '', line).split(';')[0].strip()
            if ins and not ins.startswith('/*'):
                res[cur].append(ins)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('old')
    ap.add_argument('new')
    ap.add_argument('names', nargs='+')
    ap.add_argument('--show', action='store_true', help='print the differing lines')
    args = ap.parse_args()
    a, b = functions(args.old), functions(args.new)
    for name in args.names:
        na = sorted(n for n in a if name in n)
        nb = sorted(n for n in b if name in n)
        differ = [n for n in na if a[n] != b.get(n)]
        print(f'{name}: {len(na)} / {len(nb)} functions, {len(na) - len(differ)} identical',
              flush=True)
        for n in differ if args.show else ():
            diff = list(difflib.unified_diff(a[n], b.get(n, []), lineterm='', n=0))
            print(f'  {n}: {len(a[n])} / {len(b.get(n, []))} instructions')
            print('\n'.join('    ' + d for d in diff[2:]))


if __name__ == '__main__':
    main()
