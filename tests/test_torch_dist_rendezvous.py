"""A group's rendezvous against its collectives' bound, at two gloo ranks.

``distributed.init`` and ``Group.subgroup`` wait for the other ranks up
to ``distributed.rendezvous_s(timeout_s)`` (never less than
``DEFAULT_TIMEOUT_S``); the group's collectives keep ``timeout_s``.  So a
rank that reaches the group, or a subgroup, two timeouts after the others
still forms it, and a collective that one rank never enters still fails
on the others within about one timeout.  Two ranks (the group) and three
(a subgroup of two, the third rank outside it), each a process of its
own with one torch thread.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
#: seconds: the group's collective bound; the late rank comes 2x late
TIMEOUT_S = 3.0
#: per rank process
PROC_TIMEOUT_S = 120

# argv: rank, world, the store's file, the report, TIMEOUT_S.  Rank
# world-1 joins the group 2 x TIMEOUT_S late; with three ranks, ranks 1
# and 2 ask for the subgroup [0, 1] 2 x TIMEOUT_S after rank 0.  A sum
# over the group, one over the subgroup, one more over the group; then a
# sum that only rank 0 enters.
_RANK = textwrap.dedent("""
    import json, os, sys, time
    import torch
    from repro_torch import distributed

    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    T = float(sys.argv[5])
    t0 = time.monotonic()
    if rank == world - 1:
        time.sleep(2 * T)
    late = time.monotonic() - t0
    g = distributed.init(rank, world, "cpu", store, timeout_s=T)
    rep = {"joined_s": time.monotonic() - t0, "late_s": late,
           "timeout_s": g.timeout_s}
    rep["sum"] = float(g.all_reduce(torch.ones(1)).item())
    if world == 3:
        if rank >= 1:              # rank 0 waits for rank 1 alone
            time.sleep(2 * T)
        sub = g.subgroup([0, 1])
        rep["sub_rank"] = sub.rank
        if sub.rank >= 0:
            rep["sub_sum"] = float(sub.all_reduce(
                torch.full((1,), rank + 1.0)).item())
    g.all_reduce(torch.ones(1))
    if rank == 0:
        t1 = time.monotonic()
        try:
            g.all_reduce(torch.ones(1))
            rep["raised"] = None
        except RuntimeError as e:
            rep["raised"] = str(e)[:300]
        rep["stuck_s"] = time.monotonic() - t1
    else:
        time.sleep(4 * T)          # alive, but never in rank 0's sum
    with open(out, "w") as f:
        json.dump(rep, f)
    sys.stdout.flush()
    os._exit(0)
""")


@pytest.mark.parametrize("world", [2, 3])
def test_a_late_rank_joins_and_a_missing_rank_still_times_out(world,
                                                              tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), store,
         str(tmp_path / f"rank{r}.json"), str(TIMEOUT_S)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=PROC_TIMEOUT_S)
        assert p.returncode == 0, err[-3000:]
    reps = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]
    assert distributed.rendezvous_s(TIMEOUT_S) >= \
        distributed.DEFAULT_TIMEOUT_S > 2 * TIMEOUT_S
    # the late rank came two collective timeouts after the others
    assert reps[-1]["late_s"] >= 2 * TIMEOUT_S
    for rep in reps:
        assert rep["timeout_s"] == TIMEOUT_S
        assert rep["sum"] == world
    if world == 3:
        assert [r["sub_rank"] for r in reps] == [0, 1, -1]
        assert reps[0]["sub_sum"] == reps[1]["sub_sum"] == 3.0
    # the sum rank 0 alone entered failed at the collectives' bound
    assert reps[0]["raised"], reps[0]
    assert 0.5 * TIMEOUT_S <= reps[0]["stuck_s"] <= 4 * TIMEOUT_S, reps[0]
