"""The port's wavefront scheduler against the JAX package's: identical
schedules and combine batches, the same emission order when both drivers
run the same buffers, and the overlapped butterfly equal bit for bit to
the serial one."""

import numpy as np
import pytest
import torch

from repro.core import overlap as jo
from repro_torch.core import overlap as to
from repro_torch.core import plan as tp
from repro_torch.core import tree as tr

GRID = [(b, s) for b in (1, 2, 3, 5, 8, 24) for s in (1, 2, 3)]


@pytest.mark.parametrize("n_buckets,n_stages", GRID)
def test_schedule_and_batches_identical(n_buckets, n_stages):
    ev = to.pipeline_schedule(n_buckets, n_stages)
    assert ev == jo.pipeline_schedule(n_buckets, n_stages)
    to.validate_schedule(ev, n_buckets, n_stages)
    assert to.combine_batches(ev) == jo.combine_batches(ev)
    assert to.overlapped_stage_seconds(1e-3, 2e-4, n_buckets, 2e-5) == \
        jo.overlapped_stage_seconds(1e-3, 2e-4, n_buckets, 2e-5)


def test_degenerate_schedules():
    assert to.pipeline_schedule(0, 2) == () == to.pipeline_schedule(3, 0)
    assert to.combine_batches(()) == []


def _trace(mod, bufs, bits, inv_s):
    """Drive ``mod.overlapped_butterfly`` with recording callbacks."""
    log = []

    def exchange(buf, bit):
        log.append(("x", buf.tag, bit))
        return buf

    def combine_many(accs, recvs, scale):
        log.append(("c", tuple(a.tag for a in accs), scale))
        return accs

    mod.overlapped_butterfly(bufs, bits, inv_s, exchange, combine_many)
    return log


class _Buf:
    def __init__(self, tag, n):
        self.tag, self.size = tag, n

    def numel(self):
        return self.size


def test_drivers_emit_the_same_order():
    sizes = [5, 0, 7, 3, 0, 9]
    bufs = [_Buf(i, n) for i, n in enumerate(sizes)]
    for bits in ((0, 1), (2, 0, 1), (1,)):
        assert _trace(to, bufs, bits, 0.125) == _trace(jo, bufs, bits, 0.125)


def test_overlapped_mix_matches_jax():
    bufs = [np.arange(n, dtype=np.float32) for n in (4, 0, 3)]
    issue = lambda b: b * 2
    combine = lambda b, r: b + r
    got = to.overlapped_mix([torch.from_numpy(b) for b in bufs], issue,
                            combine)
    for a, b in zip(got, jo.overlapped_mix(bufs, issue, combine)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_overlapped_equals_serial_bit_for_bit():
    rng = np.random.default_rng(0)
    P, S = 8, 4
    tree = {f"l{i}": torch.from_numpy(rng.standard_normal(
        (P, 37 * (i + 1))).astype(np.float32)) for i in range(6)}
    tree["h"] = torch.from_numpy(rng.standard_normal((P, 50)).astype(
        np.float32)).to(torch.bfloat16)
    topo = tp.Topology.flat(("data",), (P,))
    local = tr.struct(tree, drop=1)
    outs = {}
    for key, cfg in (("overlap", dict(overlap=True)),
                     ("serial", dict(overlap=False)),
                     ("per_leaf", dict(fused=False))):
        plan = tp.compile_plan(topo, local, tp.AveragingConfig(
            group_size=S, bucket_bytes=512, **cfg))
        assert plan.class_layout(0).n_buckets >= 3
        outs[key] = [plan.average_offset(tree, off) for off in plan.offsets]
    for key in ("serial", "per_leaf"):
        for a, b in zip(outs["overlap"], outs[key]):
            for name in tree:
                assert torch.equal(a[name], b[name]), (key, name)
