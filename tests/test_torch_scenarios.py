"""Scenario parity: the port's orchestrator against the JAX package's.

``run_scenario`` runs in both packages, at smoke size (the port on the
CPU), for every scenario with ``kind="train"`` and ``kind="serve"``, for
``"intercept"`` under preemption, and for the pre-copy migration of both
kinds.  Per job the two runs must agree on the lifecycle: state, step,
attempts, restarts, checkpoint count, ``last_ckpt_step`` and the
migration's state, hosts and outcome.  Each port job's digest must equal
an undisturbed port run of the same job (same kind, same total steps).

Left out as timing-dependent: every wall time, the recovery phases,
goodput and cluster goodput; image and transfer byte counts (the
packages write different image bytes); and in the straggler scenario the
checkpoint count and ``last_ckpt_step``, since a just-in-time dump fires
on a measured step time (both runs must fire at least one).
"""
import pytest
import torch

from repro.api import TransferPolicy as JaxTransferPolicy
from repro.orchestrator import run_scenario as jax_run_scenario
from repro_torch.api import TransferPolicy
from repro_torch.orchestrator import SCENARIOS, JobSpec, run_scenario
from repro_torch.orchestrator.workloads import WORKLOADS

TOTAL = 6
CASES = ([(name, kind) for kind in ("train", "serve") for name in SCENARIOS]
         + [("preemption", "intercept"), ("precopy", "train"),
            ("precopy", "serve")])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REF = {}


def _undisturbed(kind, total, tmp_path):
    """Digest of a port job of `kind` run to `total` with nothing
    injected, in slices of 2 (cached per kind and length)."""
    key = (kind, total)
    if key not in _REF:
        wl = WORKLOADS[kind](JobSpec("ref", kind=kind, total_steps=total),
                             str(tmp_path / f"ref_{kind}_{total}"),
                             device="cpu")
        wl.start()
        while not wl.done:
            wl.run_slice(2)
        wl.finish()
        _REF[key] = wl.digest()
    return _REF[key]


def _lifecycle(job, straggler):
    out = {k: job[k] for k in ("state", "step", "total_steps", "attempts",
                               "restarts", "priority", "kind")}
    if not straggler:
        out.update(checkpoints=job["checkpoints"],
                   last_ckpt_step=job["last_ckpt_step"])
    mig = job["migration"]
    out["migration"] = None if mig is None else {
        k: mig.get(k) for k in ("state", "from", "to", "outcome")}
    if mig is not None and mig.get("outcome") is not None:
        out["migration"]["rounds"] = len(mig["rounds"])
    return out


@pytest.mark.parametrize("name,kind", CASES,
                         ids=[f"{n}-{k}" for n, k in CASES])
def test_scenario_matches_reference(name, kind, tmp_path):
    kw = dict(total_steps=TOTAL, kind=kind)
    ours_kw, ref_kw = {}, {}
    scenario = name
    if name == "precopy":
        # live migration by pre-copy rounds: long enough for the rounds
        # to converge before the job ends
        scenario, kw["total_steps"] = "migrate", 12
        ours_kw["transfer_policy"] = TransferPolicy(mode="delta",
                                                    precopy_rounds=4)
        ref_kw["transfer_policy"] = JaxTransferPolicy(mode="delta",
                                                      precopy_rounds=4)
    ours = run_scenario(scenario, str(tmp_path / "port"), device="cpu",
                        **kw, **ours_kw)
    ref = jax_run_scenario(scenario, str(tmp_path / "jax"), **kw, **ref_kw)
    assert ours["all_done"] and ref["all_done"]
    assert (ours["capacity"], ours["hosts"]) == (ref["capacity"],
                                                  ref["hosts"])
    assert sorted(ours["jobs"]) == sorted(ref["jobs"])
    straggler = name == "straggler"
    for job_id, job in ours["jobs"].items():
        assert _lifecycle(job, straggler) == _lifecycle(
            ref["jobs"][job_id], straggler), job_id
        if straggler:
            assert job["jit_checkpoints"] >= 1
            assert ref["jobs"][job_id]["jit_checkpoints"] >= 1
        assert job["digest"] == _undisturbed(
            kind, job["total_steps"], tmp_path), job_id
    if name == "precopy":
        assert ours["jobs"]["mover"]["migration"]["outcome"] is not None
