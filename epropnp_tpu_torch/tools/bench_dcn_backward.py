"""Time the DCN backward (``ops/dcn_kernel.py::dcn_backward``, torch ops)
of two or more source trees of this repository on one card, in
alternating order, at the shapes of the f32 rows of ``chip_smoke.py``'s
phase m: stage 3 (L=25200, 256->256), its stride-2 first block, and FCOS
level 0 (L=100800).

Each of ROUNDS rounds times every tree once a shape, the order reversed
every other round (A B, B A, ...), so that a drift of the card's clocks
falls on both alike. Prints one JSON line a shape: each tree's times
(CUDA events around one call, ms, sorted), their median, and the largest
relative difference of the trees' gradients from the first tree's.

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python -m epropnp_tpu_torch.tools.bench_dcn_backward \\
        --tree parent=build/parent --tree change=.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

ROUNDS = 16
# (n, h, w, c, cout, stride)
SHAPES = {
    'stage3': (6, 42, 100, 256, 256, 1),
    'stage3_stride2': (6, 84, 200, 256, 256, 2),
    'fcos_level0': (6, 84, 200, 256, 256, 1),
}


def load_dcn_kernel(tree: str, name: str):
    """``ops/dcn_kernel.py`` of the source tree ``tree`` as a module of its
    own (it imports nothing of its package at import time)."""
    path = os.path.join(tree, 'epropnp_tpu_torch', 'ops', 'dcn_kernel.py')
    spec = importlib.util.spec_from_file_location(f'_dcn_kernel_{name}',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problem(shape, device, seed=0):
    """Seeded inputs of a DeformConv layer's backward: the map, offsets of
    a few pixels (some samples off the map) with mask logits, the kernel
    weight in the (9, c, cout) layout and the output's cotangent."""
    n, h, w, c, cout, stride = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn((n, h, w, c), generator=gen, device=device)
    om = torch.randn((n, ho, wo, 27), generator=gen, device=device) * 1.5
    w3 = torch.randn((9, c, cout), generator=gen, device=device) \
        * (2 / (9 * c)) ** 0.5
    go = torch.randn((n, ho, wo, cout), generator=gen, device=device)
    return x, om, w3, go, stride


def time_once(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tree', action='append', required=True,
                        help='NAME=DIR, a source tree of this repository; '
                        'give two or more')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('bench_dcn_backward: no CUDA device', file=sys.stderr)
        return 1
    trees = [t.split('=', 1) for t in args.tree]
    mods = {name: load_dcn_kernel(path, name) for name, path in trees}
    try:
        print(subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, IndexError):
        print(torch.cuda.get_device_name(0), 'power limit: not read')
    device = torch.device('cuda')
    for key in SHAPES:
        x, om, w3, go, stride = problem(SHAPES[key], device)
        calls = {name: (lambda m=m: m.dcn_backward(x, om, w3, go, stride))
                 for name, m in mods.items()}
        outs = {name: fn() for name, fn in calls.items()}   # warm-up
        first = outs[trees[0][0]]
        diff = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for out in outs.values() for a, b in zip(out, first))
        del outs, first
        times = {name: [] for name in calls}
        order = list(calls)
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(time_once(calls[name]))
        print(json.dumps(dict(
            shape=key, dims=SHAPES[key], rounds=ROUNDS,
            median_ms={k: statistics.median(v) for k, v in times.items()},
            ms={k: sorted(v) for k, v in times.items()},
            max_rel_diff=diff)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
