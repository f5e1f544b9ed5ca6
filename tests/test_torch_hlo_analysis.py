"""The port's op analysis (``repro_torch.launch.hlo_analysis``) on the CPU.

Ports of tests/test_hlo_analysis.py's eight cases to the aten op trace:
eager execution runs every iteration of a Python loop, so the analyzer
needs no trip counts (a loop of 8 matmuls counts 8 x 2 x 512^3 exactly,
nested loops multiply, bytes grow with the loop, a loop of 7 records 7
ops); a single matmul is exact; a slice is charged the slice, not its
operand; a modelled all-reduce inside a loop counts once per iteration
with the reference's ring wire bytes; ``top_buffers`` finds the big
tensor.  Then the ring wire bytes of each collective equal the
reference's ``parse_collectives`` on tests/test_dryrun_machinery.py's
HLO_SAMPLE (op, bytes, group), and the ``DTYPE_BYTES`` table equals the
reference's.  Every trace runs on the meta device.
"""
import math
import os

import pytest
import torch

from repro_torch.launch.hlo_analysis import (DTYPE_BYTES, COLLECTIVES,
                                             OpTrace, analyze_trace,
                                             ring_wire_bytes, top_buffers)
from repro_torch.launch.mesh import make_mesh


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _trace(fn, *args, **kw) -> OpTrace:
    trace = OpTrace(**kw)
    with trace:
        fn(*args)
    return trace


def test_loop_flops_counted_per_iteration():
    """A loop of 8 matmuls of 512 x 512: 8 * 2 * 512^3, every iteration
    recorded (the reference needs trip counts for its while body)."""
    W = _meta(512, 512)

    def f(c):
        for _ in range(8):
            c = torch.tanh(c @ W)
        return c

    trace = _trace(f, _meta(512, 512))
    rec = analyze_trace(trace, 1)
    assert rec["flops_by_kind"]["dot"] == 8 * 2 * 512 ** 3
    assert sum(r.op == "mm" for r in trace.records) == 8


def test_single_matmul_flops_exact():
    rec = analyze_trace(_trace(lambda a, b: a @ b, _meta(64, 128),
                               _meta(128, 32)), 1)
    assert rec["flops_by_kind"]["dot"] == 2 * 64 * 128 * 32


def test_nested_loops_multiply():
    W = _meta(128, 128)

    def f(c):
        for _ in range(5):
            for _ in range(3):
                c = c @ W
        return c

    rec = analyze_trace(_trace(f, _meta(128, 128)), 1)
    assert rec["flops_by_kind"]["dot"] == 5 * 3 * 2 * 128 ** 3


def test_memory_traffic_scales_with_iterations():
    W = _meta(256, 256)

    def f_n(n):
        def f(c):
            for _ in range(n):
                c = torch.tanh(c @ W)
            return c
        return f

    b4 = analyze_trace(_trace(f_n(4), _meta(256, 256)), 1)["bytes"]
    b16 = analyze_trace(_trace(f_n(16), _meta(256, 256)), 1)["bytes"]
    assert 2.5 < b16 / b4 < 5.5


def test_slice_counts_slice_not_operand():
    """Slicing one row per step out of a big table is charged the rows
    (twice: read and written), not the table per step."""
    table = _meta(1024, 1024)

    def f(c):
        for i in range(64):
            c = c + table[i]
        return c

    trace = _trace(f, _meta(1024))
    rec = analyze_trace(trace, 1)
    assert rec["bytes"] < 64 * 1024 * 1024 * 4
    rows = [r for r in trace.records if r.op == "select"]
    assert len(rows) == 64 and all(r.bytes == 2 * 1024 * 4 for r in rows)


def test_collectives_inside_loops_multiply():
    """A matmul contracting a dim sharded over the tp axis all-reduces its
    output (modelled): 10 iterations, 10 all-reduces of f32[1, 256] over
    4 slots, the reference's ring bytes 10 * 2 * 1024 * 3 / 4."""
    mesh = make_mesh((4,), ("model",), devices="meta")
    trace = OpTrace(mesh, tp=("model",))
    x, W = _meta(1, 1024), _meta(1024, 256)
    trace.set_tag(x, ((), (("model", 256),)))
    trace.set_tag(W, ((("model", 256),), ()))
    with trace:
        for _ in range(10):
            x @ W
    rec = analyze_trace(trace, 4)
    assert rec["collectives"]["all-reduce"]["count"] == 10
    assert rec["collective_wire_bytes"] == pytest.approx(
        10 * 2 * 256 * 4 * 3 / 4)
    # each slot holds a quarter of the contraction: a quarter of the work
    assert rec["flops_by_kind"]["dot"] == 10 * 2 * 1024 * 256 / 4
    # and each record keeps its tensors' sharding tags
    mm = trace.records[0]
    assert [t.axes for t in mm.inputs] == [((), ("model",)),
                                           (("model",), ())]
    assert mm.outputs[0].axes == ((), ()) and mm.split == 4


def test_every_iteration_recorded():
    """The reference prefers XLA's known trip count (7) over the bound in
    the loop condition; eager execution needs neither."""
    def f(c):
        for _ in range(7):
            c = c + 1
        return c

    trace = _trace(f, _meta(16))
    assert sum(r.op == "add" for r in trace.records) == 7


def test_top_buffers_finds_big_tensors():
    bufs = top_buffers(_trace(lambda x: torch.einsum("ij,kj->ik", x, x),
                              _meta(512, 256)), 3)
    assert bufs and bufs[0][0] >= 1.0                  # >= 1 MiB result


def test_dtype_bytes_table_is_the_reference():
    from repro.launch import hlo_analysis as ref
    assert DTYPE_BYTES == ref.DTYPE_BYTES


def _parse_collectives():
    """The reference's ``parse_collectives``; its module sets XLA_FLAGS on
    import (for a process it starts itself), which is put back."""
    import jax
    jax.devices()                         # this process's backend is up
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import parse_collectives
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return parse_collectives


# tests/test_dryrun_machinery.py's HLO_SAMPLE: (op, result type, group)
HLO_SAMPLE = [
    ("all-gather", "bf16[8,256,1024]", "replica_groups=[16,8]<=[128]", 8),
    ("all-reduce", "f32[1024,1024]", "replica_groups={{0,1,2,3}}", 4),
    ("reduce-scatter", "f32[128,64]", "replica_groups=[2,8]<=[16]", 8),
    ("all-to-all", "bf16[64,64]", "replica_groups={{0,1,2,3,4,5,6,7}}", 8),
    ("collective-permute", "u32[16]", "source_target_pairs={{0,1}}", 128),
]


@pytest.mark.parametrize("op,restype,groups,g", HLO_SAMPLE,
                         ids=[c[0] for c in HLO_SAMPLE])
def test_ring_wire_bytes_equal_reference(op, restype, groups, g):
    line = f"  %x = {restype}{{0}} {op}({restype}{{0}} %p), {groups}"
    ref = _parse_collectives()(line, n_devices=128)[op]
    dt, dims = restype.rstrip("]").split("[")
    nbytes = math.prod(int(d) for d in dims.split(",")) * DTYPE_BYTES[dt]
    assert ref["count"] == 1 and ref["bytes"] == nbytes
    assert ring_wire_bytes(op, nbytes, g) == pytest.approx(
        ref["wire_bytes"])
    assert op in COLLECTIVES
