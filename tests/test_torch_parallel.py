"""The host parts of the port's data parallelism (``parallel``), on the
CPU: ``HostShardSampler`` and ``PrefetchLoader`` against the JAX
package's (mirroring ``tests/test_host_sampler.py`` and
``tests/test_prefetch.py``), the collectives of ``parallel.mesh`` on a
2-rank gloo group, the rows of a rank against the global batch, bit for
bit, for both suites' data pipelines (the synthetic 6DoF set, a
LineMOD-format tree with background substitution, and the Det training
iterator on a nuScenes-format tree), and the Det evaluation rule of
``tests/test_det_multidevice.py:39-80`` on 2 ranks: the data-parallel
detections equal one single-process run per shard with the same seed.

The ranks are processes of ``tests/test_torch_dp_worker.py``, which
imports no jax.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from epropnp_tpu.parallel.sampler import HostShardSampler as JSampler
from epropnp_tpu_torch.parallel import mesh
from epropnp_tpu_torch.parallel.prefetch import PrefetchLoader
from epropnp_tpu_torch.parallel.sampler import HostShardSampler
import test_torch_dp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


# --------------------------------------------------------------- sampler

def _gather(n, hosts, **kw):
    samplers = [HostShardSampler(num_samples=n, num_hosts=hosts, host_id=h,
                                 **kw) for h in range(hosts)]
    return samplers, [s.epoch_indices(0) for s in samplers]


@pytest.mark.parametrize('kw', [
    dict(num_samples=64, num_hosts=4, seed=3),
    dict(num_samples=10, num_hosts=4),
    dict(num_samples=10, num_hosts=4, drop_last=True),
    dict(num_samples=100, num_hosts=2, seed=7),
    dict(indices=[0, 0, 1, 2, 2, 2, 3], num_hosts=2, shuffle=False),
    dict(num_samples=9, num_hosts=3, seed=2, shuffle=False)])
def test_sampler_matches_jax(kw):
    """Every host's indices over three epochs, and the length, equal the
    JAX sampler's."""
    for h in range(kw['num_hosts']):
        t = HostShardSampler(host_id=h, **kw)
        j = JSampler(host_id=h, **kw)
        assert len(t) == len(j)
        for epoch in range(3):
            np.testing.assert_array_equal(t.epoch_indices(epoch),
                                          j.epoch_indices(epoch))


def test_partition_exact_when_divisible():
    _, shards = _gather(64, 4, seed=3)
    assert all(len(s) == 16 for s in shards)
    np.testing.assert_array_equal(np.sort(np.concatenate(shards)),
                                  np.arange(64))


def test_padding_wraps_and_equal_lengths():
    _, shards = _gather(10, 4)  # ceil -> 3 per host, 2 repeats
    assert all(len(s) == 3 for s in shards)
    assert set(np.concatenate(shards)) == set(range(10))


def test_drop_last_truncates():
    _, shards = _gather(10, 4, drop_last=True)
    assert all(len(s) == 2 for s in shards)
    assert len(set(np.concatenate(shards))) == 8


def test_deterministic_and_epoch_varying():
    s = HostShardSampler(num_samples=100, num_hosts=2, host_id=1, seed=7)
    s2 = HostShardSampler(num_samples=100, num_hosts=2, host_id=1, seed=7)
    np.testing.assert_array_equal(s.epoch_indices(5), s2.epoch_indices(5))
    assert not np.array_equal(s.epoch_indices(0), s.epoch_indices(1))


def test_same_permutation_across_hosts():
    _, shards = _gather(8, 2, seed=1)
    merged = np.empty(8, np.int64)
    merged[0::2], merged[1::2] = shards[0], shards[1]
    expect = np.arange(8)[np.random.default_rng(1).permutation(8)]
    np.testing.assert_array_equal(merged, expect)


def test_epoch_batches():
    s = HostShardSampler(num_samples=32, num_hosts=2, host_id=0)
    assert [len(b) for b in s.epoch_batches(0, 4)] == [4] * 4
    assert [len(b) for b in s.epoch_batches(0, 5, drop_partial=False)] \
        == [5, 5, 5, 1]


def test_sampler_defaults_without_a_group():
    """No process group: one host, rank 0 (the group's defaults are
    checked on 2 ranks in ``test_mesh_collectives_on_two_ranks``)."""
    s = HostShardSampler(num_samples=5, seed=1)
    assert (s.num_hosts, s.host_id) == (1, 0)
    assert sorted(s.epoch_indices(0).tolist()) == list(range(5))


# -------------------------------------------------------- PrefetchLoader

def _batch(i):
    return {'x': np.full((8, 3), i, np.float32), 'i': np.int32(i)}


def test_prefetch_loader_order_and_values():
    out = list(PrefetchLoader(_batch, num_workers=3, prefetch_depth=2,
                              device='cpu')(range(17)))
    assert len(out) == 17
    for i, b in enumerate(out):
        assert int(b['i']) == i and isinstance(b['x'], torch.Tensor)
        np.testing.assert_array_equal(b['x'].numpy(), i)


def test_prefetch_loader_inline_mode():
    out = list(PrefetchLoader(_batch, num_workers=0,
                              device='cpu')(range(5)))
    assert [int(b['i']) for b in out] == list(range(5))


def test_prefetch_loader_exception_propagates():
    def bad(i):
        if i == 3:
            raise ValueError('boom')
        return _batch(i)

    got = []
    with pytest.raises(ValueError, match='boom'):
        for b in PrefetchLoader(bad, num_workers=2, prefetch_depth=1,
                                device='cpu')(range(6)):
            got.append(int(b['i']))
    assert got == [0, 1, 2]


def test_prefetch_loader_overlaps_producer():
    """Two workers over sleep-bound items take about half the serial time
    (a ratio in one process: absolute times flake on a loaded host)."""
    def slow(i):
        time.sleep(0.03)
        return _batch(i)

    t0 = time.monotonic()
    list(map(slow, range(8)))
    serial = time.monotonic() - t0
    t0 = time.monotonic()
    list(PrefetchLoader(slow, num_workers=2, prefetch_depth=2,
                        device='cpu')(range(8)))
    assert time.monotonic() - t0 < 0.8 * serial


def test_prefetch_loader_bounded_lookahead():
    """No more than ``num_workers + prefetch_depth`` items in flight: one
    yielded, at most two more taken from the source."""
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield i

    it = PrefetchLoader(_batch, num_workers=1, prefetch_depth=1,
                        device='cpu')(source())
    next(it)
    time.sleep(0.1)
    assert len(pulled) <= 1 + 1 + 1


def test_prefetch_loader_runs_make_fn_on_workers():
    main, seen = threading.get_ident(), set()

    def make(i):
        seen.add(threading.get_ident())
        return (np.arange(3) + i,)

    out = list(PrefetchLoader(make, num_workers=2, device='cpu')(range(6)))
    assert [int(b[0][0]) for b in out] == list(range(6))
    assert main not in seen


def test_prefetch_loader_composes_with_host_shard_sampler():
    sampler = HostShardSampler(num_samples=40, num_hosts=2, host_id=0,
                               seed=3)
    batches = list(PrefetchLoader(lambda idx: {'idx': np.asarray(idx)},
                                  num_workers=2, device='cpu')(
        sampler.epoch_batches(0, 4)))
    assert len(batches) == 5
    all_idx = np.concatenate([b['idx'].numpy() for b in batches])
    assert len(np.unique(all_idx)) == 20


# ------------------------------------------------------ mesh on 2 ranks

def test_rank_rows_and_take_rows():
    assert [mesh.rank_rows(12, r, 2) for r in (0, 1)] == [slice(0, 6),
                                                          slice(6, 12)]
    assert mesh.rank_rows(5) == slice(0, 5)  # no group: every row
    with pytest.raises(ValueError, match='divide'):
        mesh.rank_rows(6, 0, 4)
    batch = (np.arange(8), None, torch.arange(16).reshape(8, 2))
    a, b, c = mesh.take_rows(batch, mesh.rank_rows(8, 1, 4))
    np.testing.assert_array_equal(a, [2, 3])
    assert b is None and c.tolist() == [[4, 5], [6, 7]]


def test_mesh_without_a_group_is_the_identity():
    x = torch.arange(3.0, requires_grad=True)
    assert mesh.replica_mean(x) is x
    assert (mesh.world_size(), mesh.rank(), mesh.is_main()) == (1, 0, True)
    assert mesh.gather_to_main(7) == [7]


def _replica_mean_rule(outs):
    """For ``loss_r = (w_r . x_r) / m``, ``m = mean_r'(|x_r'|^2)``, rank r's
    gradient is ``w_r / m - 2 x_r sum_r'(w_r' . x_r') / (n m^2)``: the
    mean's cotangent summed over the ranks, as JAX's transpose of
    ``pmean`` (an in-place all-reduce gives ``w_r / m``)."""
    n = len(outs)
    m = sum(float(o['x'].square().sum()) for o in outs) / n
    dots = sum(float((o['w'] * o['x']).sum()) for o in outs)
    for o in outs:
        assert float(o['m']) == pytest.approx(m, rel=1e-14)
        want = o['w'] / m - 2 * o['x'] * dots / (n * m * m)
        torch.testing.assert_close(o['x_grad'], want, rtol=1e-12,
                                   atol=1e-15)


def test_mesh_collectives_on_two_ranks(tmp_path):
    """``replica_mean``'s value and gradient (:func:`_replica_mean_rule`;
    the mean taken by a plain in-place all-reduce, planted, fails it),
    ``mean_gradients`` (an unused parameter counts as 0),
    ``mean_buffers``, ``broadcast_state``, ``gather_to_main`` in rank
    order, ``rank_rows`` and the sampler's defaults from the group."""
    worker.spawn('mesh', str(tmp_path))
    outs = [torch.load(tmp_path / f'mesh_out_{r}.pt', weights_only=False)
            for r in range(2)]
    _replica_mean_rule(outs)
    (tmp_path / 'plant').mkdir()
    worker.spawn('mesh', str(tmp_path / 'plant'), 2, 'plain')
    planted = [torch.load(tmp_path / 'plant' / f'mesh_out_{r}.pt',
                          weights_only=False) for r in range(2)]
    with pytest.raises(AssertionError):
        _replica_mean_rule(planted)
    n = 2
    for r, o in enumerate(outs):
        for got, *local in zip(o['mean_grads'],
                               *[p['local_grads'] for p in outs]):
            torch.testing.assert_close(got, sum(local) / n, rtol=1e-14,
                                       atol=0)
        for k in ('running_mean', 'running_var'):
            torch.testing.assert_close(
                o['bn_after'][k], sum(p['bn_before'][k] for p in outs) / n,
                rtol=1e-14, atol=0)
        assert o['rows'] == slice(4 * r, 4 * r + 4)
        np.testing.assert_array_equal(
            o['sampler'], JSampler(num_samples=10, num_hosts=2, host_id=r,
                                   seed=4).epoch_indices(0))
    for a, b in zip(outs[0]['broadcast'], outs[1]['broadcast']):
        assert torch.equal(a, b)
    assert [g['rank'] for g in outs[0]['gathered']] == [0, 1]
    assert outs[1]['gathered'] is None
    assert not torch.equal(outs[0]['x'], outs[1]['x'])


# ------------------------------------------ a rank's rows, bit for bit

def test_synthetic_sixdof_rows():
    from epropnp_tpu_torch.utils.synthetic import SyntheticSixDoFDataset
    data = SyntheticSixDoFDataset(12, 32, 8, seed=2)
    whole = list(data.batches(6, seed=5))
    for r in range(3):
        rows = mesh.rank_rows(6, r, 3)
        for w, mine in zip(whole, data.batches(6, seed=5, rows=rows)):
            for a, b in zip(w, mine):
                np.testing.assert_array_equal(a[rows], b)


def test_linemod_rows_equal_the_global_batch(tmp_path):
    """``LineMODDataset.batches(rows=...)`` on a tree with background
    substitution gives each rank its rows of the global batches bit for
    bit, over two epochs, though the dataset draws per sample from one
    shared generator; and reads only the rank's frames."""
    from epropnp_tpu_torch.sixdof import config as tconfig
    from epropnp_tpu_torch.sixdof import dataset as tdataset
    from epropnp_tpu_torch.sixdof import synthetic as tsynthetic
    from epropnp_tpu_torch.utils.image_ops import write_png
    root = str(tmp_path / 'lm')
    tsynthetic.generate_dataset(root, n_train=8, n_test=0, pts_per_face=24,
                                seed=3)
    bg = tmp_path / 'bg'
    bg.mkdir()
    r = np.random.default_rng(9)
    for i, hw in enumerate(((120, 160), (100, 90))):
        write_png(str(bg / f'{i}.png'),
                  r.integers(0, 256, hw + (3,)).astype(np.uint8))
    cfg = tconfig.SixDoFConfig(dataiter=tconfig.DataIterConfig(
        inp_res=64, out_res=16))

    def dataset():
        return tdataset.LineMODDataset(cfg, root, classes=['ape'],
                                       bg_dir=str(bg), seed=4)
    whole = dataset()
    want = [list(whole.batches(4, seed=e)) for e in (0, 1)]
    for rank in (0, 1):
        mine = dataset()
        read = []
        real = mine._load
        mine._load = lambda rec: read.append(rec['stem']) or real(rec)
        rows = mesh.rank_rows(4, rank, 2)
        for e in (0, 1):
            got = list(mine.batches(4, seed=e, rows=rows))
            assert len(got) == len(want[e]) == 2
            for w, g in zip(want[e], got):
                for name, a, b in zip(w._fields, w, g):
                    assert torch.equal(a[rows], b), (rank, e, name)
        assert len(read) == 8  # 2 epochs x 2 batches x 2 rows
    assert whole.rng.bit_generator.state == mine.rng.bit_generator.state


@pytest.fixture(scope='module')
def det_tree(tmp_path_factory):
    """``chip_smoke.write_det_tree`` at 225x400: 4 train and 2 val
    keyframes of six ``.npy`` frames."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    root = str(tmp_path_factory.mktemp('dp') / 'tree')
    paths = chip_smoke.write_det_tree(root, im_hw=worker.EVAL_HW,
                                      focal=316.6)
    return root, paths


def test_det_batch_iter_rows_equal_the_global_batch(det_tree, monkeypatch):
    """``tools.train_det.make_batch_iter``'s ``batch_iter(epoch, rows)``
    (the reference's sky crop at this scale, which drops samples that the
    iterator then replaces) gives each of 2 and 3 ranks its rows of the
    global batches bit for bit over two epochs; each frame drawn is read
    by one rank only."""
    import dataclasses
    from epropnp_tpu_torch.det.config import DetConfig
    from epropnp_tpu_torch.det.nuscenes_dataset import NuScenes3DDataset
    from epropnp_tpu_torch.det.pipelines import imread
    from epropnp_tpu_torch.tools import train_det
    root, paths = det_tree
    cfg = DetConfig.smoke()
    cfg = dataclasses.replace(cfg, with_loss_regr=True,
                              train=dataclasses.replace(cfg.train,
                                                        batch_size=6))
    dataset = NuScenes3DDataset(paths['train'], img_prefix=root)
    # (0, 228, 1600, 900) at a quarter of 1600x900, cut lower so that some
    # frames lose every object
    monkeypatch.setattr(train_det, 'REFERENCE_CROP_BOX', (0, 150, 400, 225))
    dropped = []
    real_pipeline = train_det.default_pipeline

    def pipeline(sample, rng, **kw):
        out = real_pipeline(sample, rng, **kw)
        dropped.append(out is None)
        return out
    monkeypatch.setattr(train_det, 'default_pipeline', pipeline)
    whole = train_det.make_batch_iter(dataset, cfg, root)
    want = [list(whole(e)) for e in (0, 1)]
    assert any(dropped), 'the crop drops no sample here'
    attempts = len(dropped)
    for world in (2, 3):
        reads = 0
        for rank in range(world):
            read = []
            it = train_det.make_batch_iter(
                dataset, cfg, root,
                imread=lambda p: read.append(p) or imread(p))
            rows = mesh.rank_rows(6, rank, world)
            for e in (0, 1):
                got = list(it(e, rows))
                assert len(got) == len(want[e]) == 4
                for w, g in zip(want[e], got):
                    for name, a, b in zip(w._fields, w, g):
                        assert (a is None) == (b is None), name
                        if a is not None:  # NaN velocities in empty slots
                            torch.testing.assert_close(
                                b, a[rows], rtol=0, atol=0, equal_nan=True,
                                msg=f'{world} {rank} {e} {name}')
            reads += len(read)
        # every attempt's frame (a dropped one too) read by one rank only
        assert reads == attempts


def test_det_eval_data_parallel_matches_per_shard_runs(det_tree, tmp_path):
    """``tools.test_det.evaluate_dataset(data_parallel=True)`` on 2 ranks
    over the 12 val frames in batches of 6 (the smoke detector, seeded
    weights, every rank's generator seeded alike): rank 0's metrics are
    those of the detections of one single-process run per shard (rows
    0-2 and 3-5 of each batch, a fresh generator of the same seed each)
    put back in frame order, and every shard's detections exist (JAX's
    rule, ``tests/test_det_multidevice.py:39-80``, rtol/atol 1e-4)."""
    import shutil
    from epropnp_tpu_torch.det.nuscenes_dataset import NuScenes3DDataset
    from epropnp_tpu_torch.tools import test_det
    root, paths = det_tree
    shutil.copytree(root, tmp_path / 'tree')
    worker.spawn('det_eval', str(tmp_path))
    outs = [torch.load(tmp_path / f'det_eval_out_{r}.pt',
                       weights_only=False) for r in range(2)]
    assert outs[1]['metrics'] is None
    model, cfg = worker.eval_model()
    dataset = NuScenes3DDataset(paths['val'], img_prefix=root)
    per_shard = []
    with torch.no_grad():
        for r in range(2):
            per_shard += test_det.infer_dataset(
                model, cfg, dataset, root, batch_size=worker.EVAL_BATCH,
                rng=torch.Generator().manual_seed(0), shard=(r, 2))
    per_shard.sort(key=lambda x: x[0])
    assert [f for f, _ in per_shard] == list(range(len(dataset)))
    n_det = sum(len(c) for _, r in per_shard for c in r['bbox_3d_results'])
    assert n_det > 0
    want = dataset.evaluate([r for _, r in per_shard],
                            str(tmp_path / 'ref_eval'))
    got = outs[0]['metrics']
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    # the detections themselves, frame by frame, from rank 0's file
    import json
    with open(tmp_path / 'dp_eval' / 'results_nusc.json') as f:
        dp = json.load(f)['results']
    with open(tmp_path / 'ref_eval' / 'results_nusc.json') as f:
        ref = json.load(f)['results']
    assert dp.keys() == ref.keys()
    assert sum(map(len, ref.values())) > 0
    for token in ref:
        assert len(dp[token]) == len(ref[token]), token
        for a, b in zip(dp[token], ref[token]):
            assert a['detection_name'] == b['detection_name']
            np.testing.assert_allclose(
                a['translation'] + a['size'] + a['rotation']
                + [a['detection_score']],
                b['translation'] + b['size'] + b['rotation']
                + [b['detection_score']], rtol=1e-4, atol=1e-4)


def test_clis_run_data_parallel_on_two_ranks(det_tree, tmp_path):
    """``--data-parallel`` in the three CLIs on 2 gloo ranks (the torchrun
    environment) on the CPU: ``train_6dof --smoke`` (64x64 crops, a
    global batch of 4 on a 4-frame tree: one step), ``train_det --config
    smoke`` (4 frames, a global batch of 2: two steps) and ``test_det`` on
    its ``latest.pt`` (6 frames, 3 a rank); rank 0 alone writes the
    checkpoints and returns the metrics."""
    import pickle
    import shutil
    from epropnp_tpu_torch.sixdof import synthetic as tsynthetic
    root, paths = det_tree
    tree = tmp_path / 'tree'
    shutil.copytree(root, tree)
    with open(paths['train'], 'rb') as f:
        infos = pickle.load(f)
    with open(tree / 'infos_train4.pkl', 'wb') as f:
        pickle.dump(infos[:4], f)
    with open(paths['val'], 'rb') as f:
        infos = pickle.load(f)
    with open(tree / 'infos_val.pkl', 'wb') as f:
        pickle.dump(infos[:6], f)
    tsynthetic.generate_dataset(str(tmp_path / 'lm'), n_train=4, n_test=0,
                                pts_per_face=24, seed=0)
    try:
        worker.spawn('cli', str(tmp_path))
        outs = [torch.load(tmp_path / f'cli_out_{r}.pt', weights_only=False)
                for r in range(2)]
        for out in outs:
            assert out['sixdof_step'] == 1 and out['det_step'] == 2
        assert outs[1]['metrics'] is None
        assert np.isfinite(list(outs[0]['metrics'].values())).all()
        for run in ('run6d', 'rundet'):
            assert os.path.isfile(tmp_path / run / 'latest.pt')
    finally:  # the checkpoints are ~0.3 GB
        for run in ('run6d', 'rundet'):
            shutil.rmtree(tmp_path / run, ignore_errors=True)
