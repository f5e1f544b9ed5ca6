"""Images the two packages share: codec bytes, packs and manifests.

``msgpack_lite`` must produce the bytes of ``msgpack.packb(...,
use_bin_type=True)``; an image the port writes must pass the JAX
package's reader and ``repro verify``; an image the JAX package writes must
restore in the port; bf16 crosses both ways bit-exact.  The v1 writer
writes the reference's bytes, and the chunk-level surface transfer uses
(``own_chunks``, ``read_stored_chunk``, ``write_pack_v2_from_chunks``)
agrees with the reference's, with every footer round-tripping through
``msgpack_lite`` byte for byte.
"""
import os
import struct

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import cli as repro_cli
from repro.api import CheckpointOptions as JaxOptions
from repro.api import CheckpointSession as JaxSession
from repro.core.snapshot_io import SnapshotStore as JaxStore
from repro.core.snapshot_io import pack_host_blob as jax_pack_host_blob
from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.core.snapshot_io import pack_host_blob, unpack_host_blob
from repro_torch.serialization import msgpack_lite

OBJECTS = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -129, -32769, -2 ** 31 - 1, -2 ** 63,
    1.5, -0.0, float("inf"), "", "a" * 31, "a" * 32, "é" * 200,
    "x" * 70000, b"", b"y" * 255, b"z" * 70000, list(range(15)),
    list(range(16)), list(range(70000)), (1, (2, [3])),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {1: "int key", -5: None},
]


@pytest.mark.parametrize("obj", OBJECTS, ids=lambda o: repr(o)[:24])
def test_msgpack_lite_bytes_equal_msgpack(obj):
    raw = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj) == raw
    assert msgpack_lite.unpackb(raw) == msgpack.unpackb(
        raw, raw=False, strict_map_key=False)


def test_host_blob_with_numpy_bytes_equal_reference():
    blob = {"pos": 15, "tokens": np.arange(24, dtype=np.int32).reshape(2, 12),
            "scale": np.float32(0.5), "n": np.int64(3),
            "nested": {"h": np.ones((2, 3), np.float64)}}
    raw = pack_host_blob(blob)
    assert raw == jax_pack_host_blob(blob)
    back = unpack_host_blob(raw)
    np.testing.assert_array_equal(back["tokens"], blob["tokens"])
    assert back["tokens"].dtype == np.int32 and back["pos"] == 15


def _port_state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 5, generator=g),
            "b16": torch.randn(4, 6, generator=g).to(torch.bfloat16),
            "i": torch.arange(7, dtype=torch.int32),
            "scalar": torch.tensor(2.5),
            "np": np.arange(5, dtype=np.int16),
            "meta": {"name": "x", "k": 3}}


def test_port_image_passes_reference_reader_and_verify(tmp_path, capsys):
    run = str(tmp_path / "run")
    state = _port_state()
    s = CheckpointSession(run, CheckpointOptions(chunk_mb=1, stripes=3),
                          device="cpu")
    s.attach(lambda: {"st": state})
    s.register_host_state("cursor", lambda: {"pos": 7}, lambda v: None)
    s.checkpoint(4)

    assert repro_cli.main(["verify", run]) == 0
    assert "step 4: OK" in capsys.readouterr().out
    reader = JaxStore(run).reader(4)
    try:
        reader.verify_all()
        assert reader.host_state() == {"cursor": {"pos": 7}}
        for path in ("w", "i", "scalar"):
            data = reader.load_entry("st", path)["shards"][0]["data"]
            np.testing.assert_array_equal(data, state[path].numpy())
        b16 = reader.load_entry("st", "b16")
        assert b16["dtype"] == "bfloat16"
        np.testing.assert_array_equal(
            np.asarray(b16["shards"][0]["data"]).view(np.uint16),
            state["b16"].view(torch.int16).numpy().view(np.uint16))
        np.testing.assert_array_equal(
            reader.load_entry("st", "np")["data"], state["np"])
        assert reader.load_entry("st", "meta/name")["value"] == "x"
    finally:
        reader.close()


def test_reference_image_restores_in_port(tmp_path):
    run = str(tmp_path / "run")
    x = jnp.arange(12, dtype=jnp.float32).reshape(3, 4) / 7
    b = (jnp.arange(10, dtype=jnp.float32) / 3).astype(jnp.bfloat16)
    js = JaxSession(run, JaxOptions(stripes=2, chunk_mb=1))
    js.attach(lambda: {"st": {"x": x, "b": b, "np": np.ones(3, np.int8)}})
    js.register_host_state("cursor", lambda: {"pos": 3}, lambda v: None)
    js.checkpoint(2)

    got = {}
    s = CheckpointSession(run, device="cpu")
    s.register_host_state("cursor", lambda: None, got.update)
    out = s.restore()["st"]
    assert got == {"pos": 3}
    np.testing.assert_array_equal(out["x"].numpy(), np.asarray(x))
    assert out["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["b"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(b).view(np.uint16))
    np.testing.assert_array_equal(out["np"], np.ones(3, np.int8))


def test_bf16_round_trips_through_both_packages(tmp_path):
    """port -> image -> JAX -> image -> port, bit-exact."""
    t = torch.randn(5, 7).to(torch.bfloat16)
    run1, run2 = str(tmp_path / "a"), str(tmp_path / "b")
    s1 = CheckpointSession(run1, device="cpu")
    s1.attach(lambda: {"st": {"t": t}})
    s1.checkpoint(0)
    arr = JaxSession(run1, backend="host").restore()["st"]["t"]
    assert arr.dtype == jnp.bfloat16
    js = JaxSession(run2)
    js.attach(lambda: {"st": {"t": jnp.asarray(arr)}})
    js.checkpoint(0)
    back = CheckpointSession(run2, device="cpu").restore()["st"]["t"]
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))


def test_torn_latest_image_falls_back(tmp_path):
    run = str(tmp_path / "run")
    state = {"w": torch.zeros(64)}
    s = CheckpointSession(run, device="cpu")
    s.attach(lambda: {"st": state})
    s.checkpoint(1)
    state["w"] = torch.ones(64)
    s.checkpoint(2)
    stripe = os.path.join(run, "snapshots", "step_00000002",
                          "host0000.pack.0")
    with open(stripe, "r+b") as f:
        f.seek(20)
        f.write(b"\xff\xff\xff\xff")
    assert repro_cli.main(["verify", run]) == 1
    out = s.restore()["st"]["w"]
    assert torch.equal(out, torch.zeros(64))       # step 2 rejected
    with pytest.raises(IOError, match="CRC"):
        s.restore(step=2)


def test_zstd_image_raises_clear_error(tmp_path):
    pytest.importorskip("zstandard")
    run = str(tmp_path / "run")
    js = JaxSession(run, JaxOptions(compress=True))
    js.attach(lambda: {"st": {"x": jnp.zeros((256, 256), jnp.float32)}})
    js.checkpoint(0)
    with pytest.raises(IOError, match="zstd"):
        CheckpointSession(run, device="cpu").restore(step=0, verify=False)


def test_reference_v1_and_incremental_images_restore_in_port(tmp_path):
    """Older single-file (v1) packs and delta images whose entries live in
    an earlier step's pack both restore."""
    x = jnp.arange(4096, dtype=jnp.float32)
    for name, opts in (("v1", JaxOptions(pack_format=1)),
                       ("inc", JaxOptions(incremental=True, chunk_mb=1))):
        run = str(tmp_path / name)
        state = {"x": x, "y": jnp.zeros(8)}
        js = JaxSession(run, opts)
        js.attach(lambda: {"st": dict(state)})
        js.checkpoint(0)
        state["y"] = jnp.ones(8)
        js.checkpoint(1)
        if name == "inc":        # x was not rewritten: it lives in step 0
            loc = JaxStore(run).manifest(1)["locations"]["st::x::s0"]
            assert loc.startswith("step_00000000/")
        out = CheckpointSession(run, device="cpu").restore()["st"]
        np.testing.assert_array_equal(out["x"].numpy(), np.asarray(x))
        np.testing.assert_array_equal(out["y"].numpy(), np.ones(8))


def test_keep_gcs_old_images(tmp_path):
    run = str(tmp_path / "run")
    s = CheckpointSession(run, CheckpointOptions(keep=2), device="cpu")
    s.attach(lambda: {"st": {"w": torch.zeros(3)}})
    for step in range(4):
        s.checkpoint(step)
    assert s.store.list_steps() == [2, 3]


# ------------------------------------------------ chunk-level surface, v1
def _footers(run):
    """Every footer / index the images under `run` hold, as stored."""
    out = []
    for root, _d, files in os.walk(os.path.join(run, "snapshots")):
        for f in sorted(files):
            if f == "MANIFEST.json":
                continue
            with open(os.path.join(root, f), "rb") as fh:
                raw = fh.read()
            (off,) = struct.unpack("<Q", raw[8:16])
            out.append(raw[off:])
    return out


def _images_of_both_packages(tmp_path):
    """Images the footers of which the round-trip test reads: each
    package's incremental v2 chain (``ref`` chunks), compressed v2, and
    each package's v1."""
    x = np.arange(1 << 19, dtype=np.float32)      # 2 MiB: 2 chunks of 1 MiB
    runs = {}
    for pkg in ("jax", "torch"):
        for name, kw in (("inc", dict(incremental=True, chunk_mb=1)),
                         ("zlib", dict(compress=True)),
                         ("v1", dict(pack_format=1))):
            if pkg == "jax" and name == "zlib":
                continue                   # the reference writes zstd here
            run = str(tmp_path / f"{pkg}-{name}")
            for step in (0, 1):
                y = x.copy()
                y[:8] = step
                if pkg == "jax":
                    s = JaxSession(run, JaxOptions(**kw))
                    s.attach(lambda: {"st": {"x": jnp.asarray(y), "b":
                                             jnp.ones(70, jnp.bfloat16)}})
                else:
                    s = CheckpointSession(run, CheckpointOptions(**kw),
                                          device="cpu")
                    s.attach(lambda: {"st": {
                        "x": torch.from_numpy(y),
                        "b": torch.ones(70, dtype=torch.bfloat16)}})
                s.register_host_state("cursor", lambda: {"pos": 300},
                                      lambda v: None)
                s.checkpoint(step)
            runs[f"{pkg}-{name}"] = run
    return runs


def test_msgpack_lite_round_trips_every_pack_footer(tmp_path):
    """``write_pack_v2_from_chunks`` re-encodes the source footer: the
    rebuilt stripe 0 is byte-identical only if decode + encode is the
    identity on every footer either package writes (int widths, ``ref``
    records, key order)."""
    footers = [f for run in _images_of_both_packages(tmp_path).values()
               for f in _footers(run)]
    assert any(b"ref" in f for f in footers) and len(footers) > 12
    for raw in footers:
        assert msgpack_lite.packb(msgpack_lite.unpackb(raw)) == raw


def _v1_entries():
    g = np.random.default_rng(0)
    return [("w", g.standard_normal((64, 33)).astype(np.float32), None),
            ("z", np.zeros(4096, np.float32), None),           # compresses
            ("i", np.arange(7, dtype=np.int32), None),
            ("s", np.float32(2.5) * np.ones((), np.float32), None),
            ("b", (np.arange(300) % 7).astype(np.uint16), "bfloat16")]


@pytest.mark.parametrize("compress", [False, True])
def test_v1_writer_bytes_equal_reference(tmp_path, monkeypatch, compress):
    """The port's PackWriter writes the reference's bytes; compressed
    entries go through the reference's zlib branch (zstd switched off)."""
    import ml_dtypes
    from repro.serialization import pack as jpack
    from repro_torch.serialization.pack import PackReader, PackWriter
    monkeypatch.setattr(jpack, "_ZSTD", False)
    paths = {k: str(tmp_path / f"{k}.pack") for k in ("torch", "jax")}
    with PackWriter(paths["torch"], compress=compress) as w:
        for name, arr, dt in _v1_entries():
            w.add(name, arr, dtype=dt)
        w.add_bytes("__host__", b"\x80")
    with jpack.PackWriter(paths["jax"], compress=compress) as w:
        for name, arr, dt in _v1_entries():
            w.add(name, arr.view(ml_dtypes.bfloat16) if dt else arr)
        w.add_bytes("__host__", b"\x80")
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["torch"] == raw["jax"]
    if compress:
        assert b"zlib" in raw["torch"]
    # each package reads the other's
    r, jr = PackReader(paths["jax"]), jpack.PackReader(paths["torch"])
    try:
        for name, arr, dt in _v1_entries():
            np.testing.assert_array_equal(r.read_array(name), arr)
            got = jr.read_array(name)
            np.testing.assert_array_equal(
                got.view(np.uint16) if dt else got, arr)
    finally:
        r.close()
        jr.close()


def test_port_v1_images_restore_in_both_packages(tmp_path):
    """``pack_format=1`` through the session: a single-file pack per
    image, whole-entry incremental reuse, ``repro verify`` clean, and
    both packages restore the chain."""
    run = str(tmp_path / "run")
    holder = {"st": {"x": torch.arange(4096, dtype=torch.float32),
                     "b": torch.ones(8, dtype=torch.bfloat16)}}
    s = CheckpointSession(run, CheckpointOptions(pack_format=1,
                                                 incremental=True,
                                                 compress=True),
                          device="cpu")
    s.attach(lambda: dict(holder))
    s.checkpoint(0)
    holder["st"] = dict(holder["st"], b=torch.full((8,), 2.0,
                                                   dtype=torch.bfloat16))
    s.checkpoint(1)
    man = s.store.manifest(1)
    assert man["format"] == 1 and man["files"] == ["host0000.pack"]
    assert "stripes" not in man and "chunk_bytes" not in man
    assert man["locations"]["st::x::s0"].startswith("step_00000000/")
    assert man["reused_bytes"] == 4096 * 4
    assert sorted(os.listdir(os.path.join(run, "snapshots",
                                          "step_00000001"))) == \
        ["MANIFEST.json", "host0000.pack"]
    assert repro_cli.main(["verify", run]) == 0
    out = CheckpointSession(run, device="cpu").restore()["st"]
    assert torch.equal(out["x"], holder["st"]["x"])
    assert torch.equal(out["b"], holder["st"]["b"])
    js = JaxSession(run, JaxOptions())
    js.attach(lambda: {"st": None})
    jout = js.restore()["st"]
    np.testing.assert_array_equal(np.asarray(jout["x"]),
                                  holder["st"]["x"].numpy())
    np.testing.assert_array_equal(
        np.asarray(jout["b"]).view(np.uint16),
        holder["st"]["b"].view(torch.int16).numpy().view(np.uint16))


def test_chunk_surface_and_rebuild_match_reference(tmp_path):
    """``own_chunks`` / ``read_stored_chunk`` / ``pack_files`` /
    ``pack_exists`` give the reference's answers on an incremental
    child, and ``write_pack_v2_from_chunks`` rebuilds its stripes byte
    for byte (the ``ref`` chunks are not the child's to write)."""
    from repro.serialization import pack as jpack
    from repro_torch.serialization import pack as tpack
    run = _images_of_both_packages(tmp_path)["torch-inc"]
    base = os.path.join(run, "snapshots", "step_00000001", "host0000.pack")
    assert tpack.pack_files(base) == jpack.pack_files(base)
    assert tpack.pack_exists(base) and not tpack.pack_exists(base + "x")
    with tpack.open_pack(base) as r, jpack.open_pack(base) as jr:
        own = r.own_chunks()
        assert own == jr.own_chunks()
        assert 0 < len(own) < sum(len(e["chunks"])
                                  for e in r.index.values())
        for _n, _j, c in own:
            assert r.read_stored_chunk(c) == jr.read_stored_chunk(c)
        footer = {"format": 2, "stripes": r.stripes,
                  "chunk_bytes": r.chunk_bytes, "entries": r.index}
        out = str(tmp_path / "rebuilt" / "host0000.pack")
        os.makedirs(os.path.dirname(out))
        tpack.write_pack_v2_from_chunks(out, footer, r.read_stored_chunk)
    for src, dst in zip(tpack.pack_files(base), tpack.pack_files(out)):
        assert open(src, "rb").read() == open(dst, "rb").read()
    # a stored chunk that fails its CRC is never shipped
    c = own[0][2]
    with open(tpack.stripe_path(base, c["stripe"]), "r+b") as f:
        f.seek(c["offset"])
        f.write(b"\x00\x01\x02\x03")
    with tpack.open_pack(base, verify=False) as r:
        with pytest.raises(IOError, match="CRC"):
            r.read_stored_chunk(c)


@pytest.mark.parametrize("compress", [False, True])
def test_v2_writer_hashes_once_to_the_same_crcs(tmp_path, compress):
    """The v2 writer hashes each raw byte once (a batch of chunks across
    threads, the entry's CRC combined from theirs, a raw chunk's stored
    CRC its raw one): every entry's CRC and every chunk's raw and stored
    CRC is zlib's over those bytes, for an empty entry, one short chunk,
    an exact multiple of the chunk, a partial tail and more chunks than
    one hashing batch; uncompressed, the stripes are the reference
    writer's byte for byte."""
    import zlib

    from repro.serialization import pack as jpack
    from repro_torch.serialization import pack as tpack
    from repro_torch.serialization.integrity import (CRC_THREADS,
                                                     crc32_combine)
    rng = np.random.default_rng(0)
    C = 64
    arrays = {
        "empty": np.zeros(0, np.uint8),
        "short": rng.integers(0, 256, 5, dtype=np.uint8),
        "exact": rng.integers(0, 256, 3 * C, dtype=np.uint8),
        "tail": rng.integers(0, 256, 3 * C + 7, dtype=np.uint8),
        "batches": rng.integers(0, 256, (8 * CRC_THREADS + 3) * C + 1,
                                dtype=np.uint8),
        "f32": rng.standard_normal((7, 33)).astype(np.float32),
        "zeros": np.zeros(10 * C, np.uint8),          # compresses
    }
    bases = {}
    for pkg, mod in (("torch", tpack), ("jax", jpack)):
        if pkg == "jax" and compress:
            continue                  # the reference may pick another codec
        bases[pkg] = str(tmp_path / pkg / "host0000.pack")
        os.makedirs(os.path.dirname(bases[pkg]))
        w = mod.PackWriterV2(bases[pkg], compress=compress, chunk_bytes=C,
                             stripes=2, workers=1)
        for name, a in arrays.items():
            w.add(name, a)
        w.close()
    codecs = set()
    with tpack.open_pack(bases["torch"]) as r:
        for name, a in arrays.items():
            raw = a.tobytes()
            e = r.entry(name)
            assert e["crc32"] == zlib.crc32(raw), name
            assert [c["raw_crc32"] for c in e["chunks"]] == [
                zlib.crc32(raw[o:o + C]) for o in range(0, len(raw), C)]
            for c in e["chunks"]:
                codecs.add(c["codec"])
                assert c["crc32"] == zlib.crc32(r.read_stored_chunk(c))
            assert np.array_equal(r.read_array(name).reshape(a.shape), a)
    assert ("zlib" in codecs) == compress
    if not compress:
        for src, dst in zip(tpack.pack_files(bases["torch"]),
                            tpack.pack_files(bases["jax"])):
            assert open(src, "rb").read() == open(dst, "rb").read()
    for n1, n2 in [(0, 5), (5, 0), (1, 1), (1000, C), (3, 4 << 20)]:
        a = rng.integers(0, 256, n1, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, n2, dtype=np.uint8).tobytes()
        assert crc32_combine(zlib.crc32(a), zlib.crc32(b), n2) \
            == zlib.crc32(a + b)


@pytest.mark.parametrize("io_threads", [0, 4])
def test_keeping_verify_reads_each_byte_once(tmp_path, io_threads):
    """A restore's verify pass keeps what it read (`keep=True`): the
    entries it then loads equal a plain reader's, the image's stored
    bytes are read once in all, and a torn chunk still fails the pass."""
    from repro_torch.core.snapshot_io import SnapshotStore
    run = str(tmp_path / "run")
    g = torch.Generator().manual_seed(0)
    state = {"a": torch.randn(3, 200000, generator=g),
             "b": torch.randn(5, generator=g).to(torch.bfloat16),
             "c": torch.arange(10)}
    s = CheckpointSession(run, CheckpointOptions(chunk_mb=1, stripes=2),
                          device="cpu")
    s.attach(lambda: {"st": state})
    s.checkpoint(1)
    store = SnapshotStore(run)
    plain = store.reader(1)
    want = {k: plain.load_entry("st", k) for k in plain.entry_names("st")}
    stored = sum(c["nbytes"] for loc in set(plain.manifest["locations"]
                                            .values())
                 for e in plain._pack_for(loc).index.values()
                 for c in e["chunks"])
    plain.close()
    r = store.reader(1, io_threads=io_threads)
    before = r.io_stats()["read_bytes"]           # __meta__, read at open
    r.verify_all(keep=True)
    got = {k: r.load_entry("st", k) for k in r.entry_names("st")}
    host = r.host_state()
    # each stored byte once, and __meta__ once more (read at the open)
    assert r.io_stats()["read_bytes"] == stored + before
    assert before > 0
    r.close()
    for k, e in want.items():
        if e["kind"] == "device_array":
            for x, y in zip(e["shards"], got[k]["shards"]):
                assert np.array_equal(x["data"], y["data"]), k
        else:
            assert repr(e) == repr(got[k]), k
    assert host == store.reader(1).host_state()
    c = sorted(store.reader(1)._pack_for("step_00000001/host0000.pack")
               .index["st::a::s0"]["chunks"], key=lambda c: c["offset"])[1]
    from repro_torch.serialization.pack import stripe_path
    base = os.path.join(run, "snapshots", "step_00000001", "host0000.pack")
    with open(stripe_path(base, c["stripe"]), "r+b") as f:
        f.seek(c["offset"] + 8)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError, match="CRC"):
        store.reader(1, io_threads=io_threads).verify_all(keep=True)
