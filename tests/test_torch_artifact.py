"""The port's index artifacts held to the JAX package: the same on-disk
format (an index saved by either package loads in the other with equal
arrays), the crash-safe re-save, the older manifests, the registry, and
``merge_built`` / ``content_key``."""

import json

import numpy as np
import pytest
import torch

from monica_tpu.index import artifact as ref_artifact
from monica_tpu.index import build as ref_build
from monica_tpu_torch.index import artifact
from monica_tpu_torch.index import build

torch.set_num_threads(1)

SHARD_ARRAYS = artifact._SHARD_FIELDS


def _seqs(seed, glen=30_000, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, glen).astype(np.uint8) for _ in range(n)]


def _mk(seed, glen=30_000, n=2, n_shards=1):
    return build.build_index_from_arrays(
        _seqs(seed, glen, n), tax_units=[f"Sp_{seed}_{i}" for i in range(n)],
        n_shards=n_shards, device="cpu")


def _assert_same(a, b):
    assert a.meta.tax_units == b.meta.tax_units and a.meta.accessions == b.meta.accessions
    np.testing.assert_array_equal(a.meta.genome_lengths, b.meta.genome_lengths)
    assert (a.meta.k, a.meta.w, a.meta.frac, a.meta.occ_cap) == (
        b.meta.k, b.meta.w, b.meta.frac, b.meta.occ_cap)
    assert len(a.shards) == len(b.shards)
    for sa, sb in zip(a.shards, b.shards):
        for f in SHARD_ARRAYS:
            x, y = np.asarray(getattr(sa, f)), np.asarray(getattr(sb, f))
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_roundtrip_and_stale_cleanup(tmp_path):
    a = _mk(1, n_shards=2)
    artifact.save_index(a, tmp_path)
    _assert_same(artifact.load_index(tmp_path), a)
    first_files = {p.name for p in tmp_path.glob("shard*")}
    b = _mk(2, glen=20_000)
    artifact.save_index(b, tmp_path)
    _assert_same(artifact.load_index(tmp_path), b)
    # the previous generation goes after the manifest flip
    assert not ({p.name for p in tmp_path.glob("shard*")} & first_files)


def test_crash_before_manifest_flip_keeps_previous_index(tmp_path, monkeypatch):
    a = _mk(1)
    artifact.save_index(a, tmp_path)
    real_replace = artifact.os.replace

    def boom(src, dst):
        raise OSError("simulated crash before manifest flip")

    monkeypatch.setattr(artifact.os, "replace", boom)
    with pytest.raises(OSError):
        artifact.save_index(_mk(2, glen=20_000), tmp_path)
    monkeypatch.setattr(artifact.os, "replace", real_replace)
    # the manifest still names generation A, and A's files are intact
    _assert_same(artifact.load_index(tmp_path), a)
    # the next successful save removes B's orphans
    artifact.save_index(_mk(3, glen=10_000), tmp_path)
    runid = json.loads((tmp_path / artifact.MANIFEST).read_text())["runid"]
    for p in tmp_path.glob("shard*"):
        assert f".{runid}.npy" in p.name, p.name


def test_unversioned_manifest_and_v1_npz_load(tmp_path):
    """A v2 manifest without a run id names unversioned files; a v1
    artifact keeps one .npz per shard."""
    a = _mk(4)
    v2 = tmp_path / "v2"
    artifact.save_index(a, v2)
    man = json.loads((v2 / artifact.MANIFEST).read_text())
    runid = man.pop("runid")
    (v2 / artifact.MANIFEST).write_text(json.dumps(man))
    for p in v2.glob("shard*"):
        p.rename(p.with_name(p.name.replace(f".{runid}.npy", ".npy")))
    _assert_same(artifact.load_index(v2), a)

    v1 = tmp_path / "v1"
    v1.mkdir()
    man["format"] = artifact.FORMAT_V1
    (v1 / artifact.MANIFEST).write_text(json.dumps(man))
    np.savez_compressed(v1 / "shard0.npz",
                        **{f: getattr(a.shards[0], f) for f in SHARD_ARRAYS})
    _assert_same(artifact.load_index(v1), a)

    man["format"] = "something.else"
    (v1 / artifact.MANIFEST).write_text(json.dumps(man))
    with pytest.raises(ValueError, match="not a monica_tpu index"):
        artifact.load_index(v1)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_artifacts_load_across_packages(tmp_path, n_shards):
    """The JAX package's artifact loads in the port and the port's in the
    JAX package, with equal arrays and metadata."""
    seqs = _seqs(5, 25_000, 4)
    ref = ref_build.build_index_from_arrays(seqs, n_shards=n_shards)
    port = build.build_index_from_arrays(seqs, n_shards=n_shards, device="cpu")
    _assert_same(port, ref)
    ref_artifact.save_index(ref, tmp_path / "ref")
    artifact.save_index(port, tmp_path / "port")
    _assert_same(artifact.load_index(tmp_path / "ref"), ref)
    _assert_same(ref_artifact.load_index(tmp_path / "port"), port)
    a = json.loads((tmp_path / "ref" / artifact.MANIFEST).read_text())
    b = json.loads((tmp_path / "port" / artifact.MANIFEST).read_text())
    a.pop("runid"), b.pop("runid")
    assert a == b


def test_device_built_index_saves_the_host_arrays(tmp_path, monkeypatch):
    """A one-shard build on the device route (sketched and sorted on the
    device, then fetched) saves the same artifact as the host build."""
    seqs = _seqs(6, 1 << 20, 2)
    host = build.build_index_from_arrays(seqs, device="cpu")
    monkeypatch.setattr(build, "_on_device", lambda device: True)
    build.reset_build_routes()
    dev = build.build_index_from_arrays(seqs, device="cpu")
    assert build.BUILD_ROUTES == {"device_sketch_sort": 1, "overflow": 0}
    artifact.save_index(dev, tmp_path)
    _assert_same(artifact.load_index(tmp_path), host)
    _assert_same(ref_artifact.load_index(tmp_path), host)


def test_list_and_register_outside_indexes(tmp_path):
    root = tmp_path / "root"
    idir = root / "indexes"
    a = _mk(7)
    for name in ("G_b", "G_a"):
        artifact.save_index(a, idir / name)
    (idir / "not_an_index").mkdir()
    outside = tmp_path / "elsewhere" / "H_x"
    artifact.save_index(a, outside)
    for _ in range(2):  # registered once
        artifact.register_outside_index(root, outside)
    artifact.register_outside_index(root, tmp_path / "gone")  # not an index: not listed
    got = artifact.list_indexes(idir, root)
    assert got == [idir / "G_a", idir / "G_b", outside.absolute()]
    assert got == ref_artifact.list_indexes(idir, root)
    assert (root / artifact.OUTSIDE_REGISTRY).read_text().count(str(outside.absolute())) == 1


def test_merge_built_equals_reference():
    """Accession ids re-based per part; a single part passes through."""
    parts_seqs = [_seqs(8, 20_000, 2), _seqs(9, 15_000, 3)]
    port = [build.build_index_from_arrays(s, tax_units=[f"T{j}_{i}" for i in range(len(s))],
                                          device="cpu")
            for j, s in enumerate(parts_seqs)]
    ref = [ref_build.build_index_from_arrays(s, tax_units=[f"T{j}_{i}" for i in range(len(s))])
           for j, s in enumerate(parts_seqs)]
    merged = build.merge_built(port + [None])
    _assert_same(merged, ref_build.merge_built(ref))
    assert int(merged.shards[1].pos_accession_id.max()) == 4
    assert build.merge_built([port[0]]) is port[0]
    other = build.build_index_from_arrays(parts_seqs[0], k=13, device="cpu")
    with pytest.raises(ValueError, match="k/w/frac"):
        build.merge_built([port[0], other])


def test_content_key_equals_reference(tmp_path):
    genomes = []
    for i in range(3):
        p = tmp_path / f"g{i}.fna.gz"
        p.write_bytes(b"x" * (100 + i))
        genomes.append((str(p), [f"Sp_{i}", f"ACC{i}"]))
    genomes.append((str(tmp_path / "missing.fna.gz"), ["Sp_9", "ACC9"]))
    for k, w, n, frac in ((15, 10, 1, 1.0), (13, 8, 4, 0.5)):
        key = build.content_key(genomes, k, w, n, frac)
        assert key == ref_build.content_key(genomes, k, w, n, frac) and len(key) == 16
    assert build.content_key(genomes[:2], 15, 10, 1) != build.content_key(genomes, 15, 10, 1)
