"""mmap hashmaps and value stores written by one package open in the other,
eagerly and lazily, with equal values (one on-disk format)."""

import numpy as np
import pytest

import pecos_tpu.utils.mmap_hashmap_util as jmap
import pecos_tpu.utils.mmap_valstore_util as jstore
import pecos_tpu_torch.utils.mmap_hashmap_util as tmap
import pecos_tpu_torch.utils.mmap_valstore_util as tstore

PAIRS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
MAPS = {"jax": jmap, "torch": tmap}
STORES = {"jax": jstore, "torch": tstore}
MODES = ("r", "r_lazy")

WORDS = [f"word_{i}" for i in range(300)] + ["", "ünïcode «key»", "x" * 200]
FKEYS = [f"{i:08d}".encode() for i in range(0, 4000, 7)]


def _write_map(pkg, kind, path):
    m = MAPS[pkg].MmapHashmap(kind, key_len=8 if kind == "fstr2int" else None)
    m.open("w", path)
    if kind == "int2int":
        for k in range(500):
            m.map.insert(k * 7919 + 3, k - 250)
    elif kind == "str2int":
        for i, w in enumerate(WORDS):
            m.map.insert(w, 3 * i)
    else:
        for i, k in enumerate(FKEYS):
            m.map.insert(k, i)
    m.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
@pytest.mark.parametrize("kind", ["int2int", "str2int", "fstr2int"])
def test_hashmaps_cross_package(tmp_path, writer, reader, kind):
    path = str(tmp_path / f"{kind}.map")
    _write_map(writer, kind, path)
    for mode in MODES:
        r = MAPS[reader].MmapHashmap(kind)
        r.open(mode, path)
        if kind == "int2int":
            keys = np.arange(500, dtype=np.uint64) * 7919 + 3
            assert r.map.size() == 500
            np.testing.assert_array_equal(r.map.batch_get(keys, threads=2), np.arange(500) - 250)
            assert r.map.get(4, -7) == -7 and r.map[3] == -250
        elif kind == "str2int":
            assert r.map.size() == len(WORDS)
            np.testing.assert_array_equal(r.map.batch_get(WORDS), 3 * np.arange(len(WORDS)))
            assert r.map.get("absent", -2) == -2 and r.map["ünïcode «key»"] == 3 * (len(WORDS) - 2)
        else:
            assert r.map.size() == len(FKEYS) and r.key_len == 8
            np.testing.assert_array_equal(r.map.batch_get(b"".join(FKEYS)), np.arange(len(FKEYS)))
            np.testing.assert_array_equal(r.map.batch_get(FKEYS[:5]), np.arange(5))
            assert r.map.get(b"99999999", -3) == -3
            with pytest.raises(ValueError, match="exactly 8 bytes"):
                r.map.get(b"short")
        with pytest.raises(RuntimeError, match="read-only"):
            r.map.save(path + ".copy")
        r.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_value_stores_cross_package(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((64, 9)).astype(np.float32)
    strs = [f"row {i} " * (i % 5) for i in range(40)] + ["ünïcode — «text»", ""]
    fpath, bpath = str(tmp_path / "f32.store"), str(tmp_path / "bytes.store")
    STORES[writer].Float32Store.from_array(arr).save(fpath)
    STORES[writer].BytesStore.from_list(strs).save(bpath)
    rows = np.array([0, 63, 5, 5, 17], np.uint64)
    for lazy in (False, True):
        f = STORES[reader].Float32Store.load(fpath, lazy=lazy)
        assert f.shape == arr.shape
        np.testing.assert_array_equal(f.get_rows(rows, threads=2), arr[rows.astype(np.int64)])
        cols = np.array([0, 8, 3, 3, 1], np.uint64)
        np.testing.assert_array_equal(f.batch_get(rows, cols), arr[rows.astype(np.int64), cols.astype(np.int64)])
        b = STORES[reader].BytesStore.load(bpath, lazy=lazy)
        assert b.nr_rows == len(strs)
        want = [s.encode() for s in strs]
        assert b.batch_get(np.arange(len(strs), dtype=np.uint64), trunc_len=64) == [w[:64] for w in want]
        assert b.batch_get(np.array([40], np.uint64), trunc_len=4) == [want[40][:4]]


def test_missing_files_raise(tmp_path):
    with pytest.raises(IOError):
        tmap.MmapHashmap("str2int").open("r", str(tmp_path / "absent.map"))
    with pytest.raises(IOError):
        tstore.Float32Store.load(str(tmp_path / "absent.store"))
    with pytest.raises(ValueError, match="map_type"):
        tmap.MmapHashmap("str2str")


@pytest.mark.parametrize("threads", [1, 4, -1])
def test_threaded_batch_gets(tmp_path, threads):
    """Batches large enough to run on several host threads (csrc/parallel.h)
    read the same values as one thread, lazily loaded too."""
    rng = np.random.default_rng(1)
    keys = rng.choice(1 << 40, size=60_000, replace=False).astype(np.uint64)
    m = tmap.MmapHashmap("int2int")
    m.open("w", str(tmp_path / "big.map"))
    for i, k in enumerate(keys[:30_000].tolist()):
        m.map.insert(k, i)
    m.close()
    r = tmap.MmapHashmap("int2int").open("r_lazy", str(tmp_path / "big.map"))
    want = np.concatenate([np.arange(30_000), np.full(30_000, -5)])
    np.testing.assert_array_equal(r.map.batch_get(keys, default=-5, threads=threads), want)
    r.close()
    arr = rng.standard_normal((20_000, 3)).astype(np.float32)
    tstore.Float32Store.from_array(arr).save(str(tmp_path / "big.store"))
    f = tstore.Float32Store.load(str(tmp_path / "big.store"), lazy=True)
    rows = rng.integers(0, 20_000, size=50_000).astype(np.uint64)
    np.testing.assert_array_equal(f.get_rows(rows, threads=threads), arr[rows.astype(np.int64)])
