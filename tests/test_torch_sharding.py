"""The port's meshes, sharding policies and sharded images on the CPU.

Ports tests/test_policy.py to ``repro_torch.sharding``: every named
policy's spec for a set of logical-axis tuples (contested axes and
unknown names included) equals the reference's, and so do ``for_mesh``,
ZeRO stage 1, the decode-cache choice and ``fit_spec`` (a grid of dims
and axis sizes here; the reference's hypothesis sweep where hypothesis
is installed).  Then the image side, on a (4, 2) mesh of CPU slots: the
topology fingerprint equals JAX's, and sync, async, incremental and
concurrent capture and a lazy restore each round-trip a sharded state
bit-exact, one block per distinct block; an incremental image after a
step that changed one block reuses every other block's chunks.  A
``cuda``-marked test holds a (4, 2) card-slot image's identical-mode
restore against the whole-tensor restore.  The JAX package is imported
inside the parity tests, so the card's machine (no JAX) runs the
``cuda`` test from this file.
"""
import dataclasses

import pytest
import torch

from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.api.capabilities import capabilities, check
from repro_torch.core.topology import (mesh_fingerprint, resolve_sharding,
                                       sharding_descriptor, spec_from_json,
                                       spec_to_json)
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh
from repro_torch.sharding import (POLICIES, NamedSharding, PartitionSpec,
                                  cache_policy, fit_sharding, fit_spec,
                                  get_policy)

P = PartitionSpec


def _ref(module: str):
    """A module of the JAX package (parity tests only)."""
    return pytest.importorskip(module)


def _jax_json(spec) -> list:
    return _ref("repro.core.topology").spec_to_json(spec)

AXES = [("batch",), ("heads",), ("d_model",), ("experts",), ("cache_seq",),
        ("vocab",), ("ssm_inner",), ("seq",), ("batch", "cache_seq"),
        ("layers", "batch", "cache_seq", "kv_heads", None),
        ("d_model", "heads", None), ("heads", "d_model"),
        ("batch", "seq", "act_d"), ("vocab", "d_model"),
        ("experts", "d_model", "moe_ff"), (None, "vocab"), ()]


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- policies
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_specs_match_reference(name):
    ref = _ref("repro.sharding.policy").POLICIES[name]
    port = POLICIES[name]
    assert port.table() == ref.table()
    for axes in AXES:
        assert spec_to_json(port.spec(*axes)) == \
            _jax_json(ref.spec(*axes)), (name, axes)
    for bad in (("nonsense",), ("batch", "bogus")):
        with pytest.raises(KeyError):
            ref.spec(*bad)
        with pytest.raises(KeyError):
            port.spec(*bad)


def test_baseline_roles_and_first_dim_wins():
    p = get_policy("baseline")
    assert p.spec("batch") == P(("pod", "data"))
    assert p.spec("heads") == P("model")
    assert p.spec("d_model") == P("data")
    assert p.spec(None, "vocab") == P(None, "model")
    assert p.spec("batch", "cache_seq") == P(("pod", "data"), None)
    assert get_policy("tp_only").spec("d_model") == P(None)   # ZeRO-1
    with pytest.raises(KeyError):
        get_policy("nope")


@pytest.mark.parametrize("mesh", [dict(data=1, model=1),
                                  dict(pod=2, data=4, model=2),
                                  dict(model=8)], ids=str)
def test_for_mesh_matches_reference(mesh):
    refs = _ref("repro.sharding.policy").POLICIES
    for name in refs:
        ref = refs[name].for_mesh(FakeMesh(**mesh))
        port = POLICIES[name].for_mesh(FakeMesh(**mesh))
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name


@pytest.mark.parametrize("batch", [None, 1, 3, 8, 32, 128])
def test_cache_policy_matches_reference(batch):
    mesh = FakeMesh(pod=2, data=16, model=16)
    refs = _ref("repro.sharding.policy").POLICIES
    jax_cache_policy = _ref("repro.models.lm")._cache_policy
    for name in refs:
        ref = jax_cache_policy(refs[name], mesh, batch)
        port = cache_policy(POLICIES[name], mesh, batch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
    base = cache_policy(get_policy("baseline"), mesh, 1)
    assert base.dp == () and base.seq == ("pod", "data")


FIT_SPECS = [("data", "model"), ("model", "data"), "data", "model", None]


@pytest.mark.parametrize("data", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("model", [1, 2, 4, 8, 16])
def test_fit_spec_matches_reference(data, model):
    JP = _ref("jax.sharding").PartitionSpec
    jax_fit_spec = _ref("repro.sharding.policy").fit_spec
    sizes = {"data": data, "model": model}
    for dim in list(range(1, 65)) + [151936, 4864, 8 * 16]:
        for e in FIT_SPECS:
            for spec_p, spec_j, shape in ((P(e, None), JP(e, None), (dim, 6)),
                                          (P(None, e), JP(None, e), (6, dim))):
                assert spec_to_json(fit_spec(spec_p, shape, sizes)) == \
                    _jax_json(jax_fit_spec(spec_j, shape, sizes))


def test_fit_spec_divisibility_property():
    """The reference's property test (tests/test_policy.py:64) where
    hypothesis is installed."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st
    JP = _ref("jax.sharding").PartitionSpec
    jax_fit_spec = _ref("repro.sharding.policy").fit_spec

    @settings(max_examples=60, deadline=None)
    @given(dim=st.integers(1, 64),
           data=st.sampled_from([1, 2, 4, 8, 16]),
           model=st.sampled_from([1, 2, 4, 8, 16]))
    def prop(dim, data, model):
        sizes = {"data": data, "model": model}
        assert spec_to_json(fit_spec(P(("data", "model")), (dim,), sizes)) \
            == _jax_json(jax_fit_spec(JP(("data", "model")), (dim,), sizes))
    prop()


def test_fit_keeps_vocab_sharded_and_replicates_few_kv_heads():
    mesh = make_mesh((4, 2), ("data", "model"), devices="cpu")
    wide = make_mesh((1, 16), ("data", "model"), devices="cpu")
    assert fit_spec(P("model"), (151936,), {"model": 8}) == P("model")
    sh = fit_sharding(NamedSharding(wide, P(None, None, "model")),
                      (2, 1024, 8))
    assert sh.spec == P(None, None, None)
    assert fit_sharding(NamedSharding(mesh, P(("data", "model"))),
                        (6,)).spec == P("model")


# ------------------------------------------------------------- meshes
def test_mesh_is_slots_on_one_device():
    m = make_host_mesh(data=4, model=2, device="cpu")
    assert m.shape == {"data": 4, "model": 2}
    assert m.axis_names == ("data", "model") and m.size == 8
    assert m.device == torch.device("cpu")
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert make_host_mesh(pod=2, data=2, device="cpu").axis_names == \
        ("pod", "data", "model")
    with pytest.raises(ValueError, match="one device"):
        make_mesh((2,), ("data",), devices=["cpu", "meta"])
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",), devices="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh((1,), ("data",))            # the card by default


def test_named_sharding_blocks_and_replicas():
    m = make_mesh((4, 2), ("data", "model"), devices="cpu")
    sh = NamedSharding(m, P(None, "model"))
    assert sh.replica_ids((2, 8)) == {(d, k): d for d in range(4)
                                      for k in range(2)}
    assert sh.shard_indices((2, 8)) == [(slice(None), slice(0, 4)),
                                        (slice(None), slice(4, 8))]
    both = NamedSharding(m, P(("model", "data")))
    assert [s[0].start for s in both.shard_indices((16,))] == \
        [0, 8, 2, 10, 4, 12, 6, 14]                 # "model" major
    with pytest.raises(ValueError):
        NamedSharding(m, P("pod"))
    with pytest.raises(ValueError):
        NamedSharding(m, P("data", "data"))
    with pytest.raises(ValueError):
        sh.devices_indices_map((2, 5))              # 5 does not split in 2


def test_fingerprint_and_descriptors():
    m = make_mesh((4, 2), ("data", "model"), devices="cpu")
    assert mesh_fingerprint(m) == {
        "kind": "cpu", "n_devices": 8, "mesh_shape": [4, 2],
        "mesh_axes": ["data", "model"], "process_count": 1}
    assert mesh_fingerprint(None, torch.device("cpu"))["mesh_shape"] is None
    t = torch.zeros(8, 4)
    assert sharding_descriptor(t)["type"] == "other"
    d = sharding_descriptor(t, NamedSharding(m, P(("data", "model"))))
    assert d["spec"] == [["data", "model"]] and d["type"] == "named"
    assert spec_from_json(d["spec"]) == P(("data", "model"))
    small = make_mesh((2,), ("data",), devices="cpu")
    assert resolve_sharding(d, small).spec == P(("data",))
    assert resolve_sharding(sharding_descriptor(t), small) is None


def test_capabilities_report_elastic_restore_and_probe_a_mesh():
    assert capabilities()["features"]["elastic_restore"] is True
    assert check(device="cpu").ok
    rep = check(device="nonsense-device")
    assert any("mesh construction failed" in p for p in rep.problems)


# ------------------------------------------------------------- images
def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(2, 16, 8, generator=g),        # dims 1 and 2
            "emb": torch.randn(32, 8, generator=g),
            "b": torch.randn(16, generator=g).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32),
            "rep": torch.randn(5, generator=g)}


def _shardings(mesh):
    return {"w": NamedSharding(mesh, P(None, "data", "model")),
            "emb": NamedSharding(mesh, P("model", None)),
            "b": NamedSharding(mesh, P(("data", "model"))),
            "step": NamedSharding(mesh, P()),
            "rep": None}                            # written whole


def _blocks(run, step, path):
    from repro_torch.core.snapshot_io import SnapshotStore
    return SnapshotStore(run).reader(step).meta["st"][path]


MODES = {"sync": dict(mode="sync"), "async": dict(mode="async"),
         "incremental": dict(mode="sync", incremental=True),
         "concurrent": dict(capture="concurrent", incremental=True),
         "lazy": dict(restore_mode="lazy", critical_states=("st/w",))}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_modes_round_trip_sharded_state(mode, tmp_path):
    mesh = make_mesh((4, 2), ("data", "model"), devices="cpu")
    run = str(tmp_path / "run")
    state = _state()
    opts = CheckpointOptions(**MODES[mode])
    s = CheckpointSession(run, opts, mesh=mesh)
    s.attach(lambda: {"st": state}, {"st": _shardings(mesh)})
    if mode == "concurrent":
        h = s.checkpoint_begin(1)
        h.wait_speculated()
        state["w"][:, :4] += 1.0                  # one block, in place
        s.checkpoint_finalize()
        assert s.last_stats["recaptured_entries"] >= 1
    else:
        s.checkpoint(1)
    s.wait_pending()
    meta = {p: _blocks(run, 1, p) for p in state}
    assert len(meta["w"]["shards"]) == 8 and len(meta["emb"]["shards"]) == 2
    assert len(meta["b"]["shards"]) == 8 and len(meta["step"]["shards"]) == 1
    assert meta["rep"]["sharding"]["type"] == "other"
    assert meta["w"]["sharding"]["spec"] == [None, ["data"], ["model"]]
    if mode == "incremental":
        state["w"][1, 12:, 4:] += 1.0             # block (3, 1) alone
        s.checkpoint(2)
        assert s.last_stats["written_bytes"] == 2 * 4 * 4 * 4   # f32
        assert s.store.manifest(2)["parent"] == 1
    r = CheckpointSession(run, opts, mesh=mesh)
    out = r.restore()
    if mode == "lazy":
        out = r.restore_barrier()
    assert r.last_stats["topology_mode"] == "identical"
    assert r.last_stats["placed_blocks"] >= 8 + 2 + 8
    assert "assembled_entries" not in r.last_stats
    for k, v in state.items():
        assert out["st"][k].dtype == v.dtype
        assert torch.equal(out["st"][k], v), k


def test_restore_onto_other_meshes_reassembles(tmp_path):
    mesh = make_mesh((4, 2), ("data", "model"), devices="cpu")
    run = str(tmp_path / "run")
    state = _state(1)
    s = CheckpointSession(run, mesh=mesh)
    s.attach(lambda: {"st": state}, {"st": _shardings(mesh)})
    s.checkpoint(1)
    for target, mode in ((make_mesh((2, 2), ("data", "model"),
                                    devices="cpu"), "resharded"),
                         (None, "resharded"),
                         (Mesh(mesh.devices.copy(), mesh.axis_names),
                          "identical")):
        r = CheckpointSession(run, device="cpu", mesh=target)
        out = r.restore()
        assert r.last_stats["topology_mode"] == mode
        for k, v in state.items():
            assert torch.equal(out["st"][k], v), (mode, k)
    r = CheckpointSession(run, device="cpu")
    shard = {"st": {"w": NamedSharding(mesh, P(None, "data", "model"))}}
    r.restore(mesh=make_mesh((2, 2), ("data", "model"), devices="cpu"),
              shardings=shard)
    assert r.last_stats["assembled_entries"] == 1   # b: 8 blocks, now 4


@pytest.mark.cuda
def test_card_slot_identical_restore_against_whole(tmp_path):
    """On the card: a (4, 2) image of card slots restores identical,
    block by block, equal to the whole-tensor restore of the same bytes
    (chip_smoke.py phase 8 (c) times both at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run python3 chip_smoke.py on "
                    "the card")
    mesh = make_mesh((4, 2), ("data", "model"), devices="cuda")
    state = {k: v.cuda() for k, v in _state(2).items()}
    s = CheckpointSession(str(tmp_path / "run"), mesh=mesh)
    s.attach(lambda: {"st": state}, {"st": _shardings(mesh)})
    s.checkpoint(1)
    r = CheckpointSession(str(tmp_path / "run"), mesh=mesh)
    got = r.restore()["st"]
    assert r.last_stats["topology_mode"] == "identical"
    whole = CheckpointSession(str(tmp_path / "run"), device="cuda")
    ref = whole.restore()["st"]
    assert whole.last_stats["topology_mode"] == "resharded"
    for k, v in state.items():
        assert got[k].is_cuda and torch.equal(got[k], ref[k])
        assert torch.equal(got[k], v)
