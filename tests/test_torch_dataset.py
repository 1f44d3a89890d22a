"""The port's host-side data layer against the JAX package's.

Both are pure numpy, so the comparison is bit for bit: the synthetic
dataset's files, every uint8 batch of ``batches`` (order, seeding,
``drop_last``, host striding, the worker pool, D4 augmentation), the raw
decode cache and the PNG codecs.
"""
import os

import numpy as np
import pytest
import torch

from srcgan_tpu.data import dataset as jds
from srcgan_tpu.utils import vis as jvis
from srcgan_tpu_torch import data
from srcgan_tpu_torch.data import dataset as ds
from srcgan_tpu_torch.data import native, preprocess
from srcgan_tpu_torch.utils import vis


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    data.make_synthetic_dataset(str(d / "Sat2Aerx1"), n_train=11, n_val=2, n_test=3,
                                size=32, seed=3)
    data.make_synthetic_dataset(str(d / "Wide"), n_train=5, n_val=1, n_test=1,
                                size=24, seed=4, scale=2, colorizable=True)
    return str(d)


@pytest.mark.parametrize("kw", [dict(), dict(scale=2), dict(colorizable=True),
                                dict(colorizable=True, scale=4, seed=7)],
                         ids=["default", "x2", "colorizable", "colorizable-x4"])
def test_synthetic_dataset_files_equal_jax(tmp_path, kw):
    ours, theirs = tmp_path / "ours" / "Sat2Aerx1", tmp_path / "theirs" / "Sat2Aerx1"
    args = dict(n_train=3, n_val=1, n_test=2, size=32, **kw)
    assert data.make_synthetic_dataset(str(ours), **args) == "Sat2Aerx1"
    jds.make_synthetic_dataset(str(theirs), **args)
    for split in ("train", "val", "test"):
        assert (ours / f"{split}.txt").read_text() == (theirs / f"{split}.txt").read_text()
    for sub in ("src", "tar"):
        names = sorted(os.listdir(theirs / sub))
        assert sorted(os.listdir(ours / sub)) == names and len(names) == 6
        for name in names:
            a, b = ds._read_png(str(ours / sub / name)), jds._read_png(str(theirs / sub / name))
            assert a.shape == b.shape and np.array_equal(a, b)


BATCH_CASES = {
    "plain": dict(batch_size=4),
    "shuffle": dict(batch_size=4, shuffle=True, seed=5, epoch=2),
    "drop-last": dict(batch_size=4, shuffle=True, seed=1, drop_last=True),
    "augment": dict(batch_size=3, shuffle=True, seed=2, epoch=1, augment=True),
    "workers": dict(batch_size=2, shuffle=True, seed=2, epoch=1, augment=True, workers=3),
    "host-0-of-2": dict(batch_size=2, shuffle=True, seed=9, host_id=0, num_hosts=2),
    "host-1-of-2": dict(batch_size=2, shuffle=True, seed=9, host_id=1, num_hosts=2,
                        drop_last=True, augment=True),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batches_bit_equal_to_jax(synth, case):
    kw = BATCH_CASES[case]
    ours = list(data.batches(data.FileListDataset("Sat2Aerx1", "train", data_dir=synth), **kw))
    theirs = list(jds.batches(jds.FileListDataset("Sat2Aerx1", "train", data_dir=synth), **kw))
    assert len(ours) == len(theirs) > 0
    for (s, t, i), (js, jt, ji) in zip(ours, theirs):
        assert s.dtype == t.dtype == np.uint8
        assert np.array_equal(i, ji) and np.array_equal(s, js) and np.array_equal(t, jt)


def test_augment_on_non_square_images_keeps_shapes(tmp_path):
    """Only the four shape-preserving D4 ops are drawn for non-square pairs,
    as in the JAX package: same batches."""
    from PIL import Image

    root = tmp_path / "Rect"
    rng = np.random.default_rng(0)
    names = [f"r{i}.png" for i in range(5)]
    for sub in ("src", "tar"):
        os.makedirs(root / sub)
        for n in names:
            Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)).save(root / sub / n)
    (root / "train.txt").write_text("\n".join(names) + "\n")
    kw = dict(batch_size=2, shuffle=True, seed=4, augment=True)
    ours = list(data.batches(data.FileListDataset("Rect", "train", data_dir=str(tmp_path)), **kw))
    theirs = list(jds.batches(jds.FileListDataset("Rect", "train", data_dir=str(tmp_path)), **kw))
    for (s, t, _), (js, jt, _) in zip(ours, theirs):
        assert s.shape[1:] == (16, 24, 3)
        assert np.array_equal(s, js) and np.array_equal(t, jt)


@pytest.mark.parametrize("op", range(8))
def test_dihedral_equals_jax(op):
    img = np.random.default_rng(op).integers(0, 256, (6, 6, 3), dtype=np.uint8)
    assert np.array_equal(data.dihedral(img, op), jds.dihedral(img, op))


def test_cached_dataset_equals_the_uncached(synth, tmp_path):
    plain = data.FileListDataset("Wide", "train", data_dir=synth)
    cached = data.CachedDataset(plain, cache_dir=str(tmp_path / "cache"))
    again = data.CachedDataset(plain, cache_dir=str(tmp_path / "cache"))     # memmap reuse
    assert len(cached) == len(plain) == 5 and cached.datalist == plain.datalist
    for i in range(len(plain)):
        for a, b, c in zip(plain.raw(i), cached.raw(i), again.raw(i)):
            assert np.array_equal(a, b) and np.array_equal(a, c)
    kw = dict(batch_size=2, shuffle=True, seed=1, augment=True)
    for (s, t, i), (cs, ct, ci) in zip(data.batches(plain, **kw), data.batches(cached, **kw)):
        assert np.array_equal(i, ci) and np.array_equal(s, cs) and np.array_equal(t, ct)
    assert plain.raw(0)[0].shape == (12, 12, 3) and plain.raw(0)[1].shape == (24, 24, 3)


def test_getitem_matches_jax(synth):
    ours = data.G2RGB("Sat2Aerx1", "val", data_dir=synth)[1]
    theirs = jds.G2RGB("Sat2Aerx1", "val", data_dir=synth)[1]
    assert ours["idx"] == theirs["idx"] == 1
    for k in ("src", "tar"):
        assert ours[k].dtype == np.float32 and ours[k].shape == theirs[k].shape
        np.testing.assert_allclose(ours[k], theirs[k], atol=1e-6, rtol=0)


def test_show_writes_the_preview(synth, tmp_path):
    out = data.G2RGB("Sat2Aerx1", "test", data_dir=synth).show(0, example_dir=str(tmp_path))
    assert ds._read_png(out).shape == (32 + 10, 2 * (32 + 10), 3)


def test_load_dataset_and_normalize(synth, monkeypatch):
    monkeypatch.setattr(ds, "DATASET_DIR", synth)
    train, val, test = data.load_dataset("Sat2Aerx1")
    assert (len(train), len(val), len(test)) == (11, 2, 3)
    a = np.array([2.0, 4.0, 6.0])
    assert np.array_equal(data.normalize(a), jds.normalize(a))


def test_lab_variant_names_its_roadmap_item(synth, tmp_path, monkeypatch):
    """LAB is ported (it once raised naming its ROADMAP item): the G2LAB class,
    its samples, its preview and tensor2img(mode="LAB") equal the JAX package's;
    samples within 2e-5 on normalized LAB, images within 1 LSB."""
    lab, jlab = (m.G2LAB("Sat2Aerx1", "train", data_dir=synth) for m in (data, jds))
    assert lab.ver == "G2LAB" and len(lab) == len(jlab)
    monkeypatch.setattr(ds, "DATASET_DIR", synth)
    assert [type(s).__name__ for s in data.load_dataset("Sat2Aerx1", ver="G2LAB")] == ["G2LAB"] * 3
    got, want = lab[0], jlab[0]
    assert got["tar"].shape == want["tar"].shape and got["tar"].dtype == np.float32
    assert np.abs(got["tar"] - want["tar"]).max() <= 2e-5
    assert np.abs(got["src"] - want["src"]).max() <= 1e-6
    a = ds._read_png(lab.show(0, example_dir=str(tmp_path / "port"))).astype(int)
    b = ds._read_png(jlab.show(0, example_dir=str(tmp_path / "jax"))).astype(int)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    rng = np.random.default_rng(0)
    for channels in (3, 2):          # a 2-channel ab map reads as (a, b, b) in both
        x = rng.uniform(0, 1, (1, 8, 8, channels)).astype(np.float32)
        a, b = vis.tensor2img(x, "LAB", (8, 8)), jvis.tensor2img(x, "LAB", (8, 8))
        assert a.shape == b.shape == (8, 8, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_png_codecs_agree(synth, tmp_path, monkeypatch):
    """The native libpng codec (where it builds) and PIL write and read the
    same pixels, for RGB and gray, one image and a batch."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (3, 20, 28, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (20, 28), dtype=np.uint8)

    def write(tag):
        paths = [str(tmp_path / f"{tag}-{i}.png") for i in range(3)]
        vis.save_png_batch(paths, rgb)
        vis.save_png(str(tmp_path / f"{tag}-gray.png"), gray)
        return paths + [str(tmp_path / f"{tag}-gray.png")]

    first = write("a")
    codec = native.codec()
    if native.available():
        assert native.probe(first[0]) == (20, 28)
        assert np.array_equal(native.decode_batch(first[:3], 20, 28), rgb)
        built = os.listdir(os.path.dirname(native._build()))
        assert os.path.basename(native._build()) in built       # in the package's _build/
        assert os.path.dirname(native._build()).endswith(os.path.join("srcgan_tpu_torch", "_build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)                  # as if it did not build
    assert not native.available() and native.codec() == "PIL"
    second = write("b")
    for a, b in zip(first, second):
        assert np.array_equal(ds._read_png(a), ds._read_png(b))
    for i in range(3):
        assert np.array_equal(ds._read_png(second[i]), rgb[i])
    assert np.array_equal(ds._read_png(second[3])[..., 0], gray)
    src, tar = data.FileListDataset("Sat2Aerx1", "test", data_dir=synth).raw_batch([2, 0])
    assert src.shape == tar.shape == (2, 32, 32, 3)              # the PIL path of raw_batch
    assert codec in ("PIL", "libpng (native, C++ threads)")


def test_vis_helpers_equal_jax():
    from srcgan_tpu.utils import vis as jvis

    x = np.random.default_rng(2).uniform(-0.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    g = x[..., :1]
    for a in (x, g):
        assert np.array_equal(vis.tensor2image_u8(np.clip(a, 0, 1)),
                              jvis.tensor2image_u8(np.clip(a, 0, 1)))
        assert np.array_equal(vis.tensor2img(a, "RGB", dsize=(8, 8)),
                              jvis.tensor2img(a, "RGB", dsize=(8, 8)))
        assert np.array_equal(vis.tensor2img(torch.from_numpy(a), "RGB"),
                              jvis.tensor2img(a, "RGB"))
    img = vis.tensor2img(x, "RGB", dsize=(8, 8))
    assert np.array_equal(vis.whitespace(img), jvis.whitespace(img))
    assert np.array_equal(vis.add_barrier(img), jvis.add_barrier(img))
    assert np.array_equal(vis.patch2vis(img, img), jvis.patch2vis(img, img))


def test_device_put_iter_stages_one_step_ahead():
    """Batch k+1 is staged before batch k is handed out; the order, the
    values and non-array items are kept."""
    pulled = []

    def source():
        for i in range(4):
            pulled.append(i)
            yield np.full((2, 3), i, np.uint8), np.full((2,), i, np.float32), [i, i + 1]

    seen = []
    for k, (a, b, idx) in enumerate(preprocess.device_put_iter(source(), "cpu")):
        seen.append(k)
        assert isinstance(a, torch.Tensor) and a.dtype == torch.uint8 and a.device.type == "cpu"
        assert a.tolist() == [[k] * 3] * 2 and b.tolist() == [float(k)] * 2 and idx == [k, k + 1]
        assert len(pulled) == min(k + 2, 4)
    assert seen == [0, 1, 2, 3]
    assert list(preprocess.device_put_iter(iter(()), "cpu")) == []
