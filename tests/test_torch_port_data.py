"""clsurvey_torch's image-folder datasets against clsurvey_tpu's on the CPU.

The raw trees are the fixtures of ``tests/test_dataprep.py``, built inside
the test with PIL: a fake ``tiny-imagenet-200`` (every survey wnid, 5 train
and 2 val images of 64 px), an iNaturalist supercategory/species tree and
a RecogSeq train/test tree with unequal class counts. One raw tree prepared
by both packages gives the same npz arrays, bit for bit (tolerance 0: the
same PIL reads and the same numpy ``default_rng`` draws), and each package
reads the bundles the other wrote."""

import filecmp
import os

import numpy as np
import pytest

from clsurvey_torch.data import imagefolders as timf
from clsurvey_torch.data import inaturalist as tinat
from clsurvey_torch.data import recogseq as trs
from clsurvey_torch.data import registry as treg
from clsurvey_torch.data import tinyimagenet as ttiny
from clsurvey_torch.utils import config as tconfig
from clsurvey_tpu.data import imagefolders as jimf
from clsurvey_tpu.data import inaturalist as jinat
from clsurvey_tpu.data import recogseq as jrs
from clsurvey_tpu.data import tinyimagenet as jtiny

from PIL import Image

SPLITS = ("train_images", "train_labels", "val_images", "val_labels",
          "test_images", "test_labels", "classes")


def _write_png(path, value, px=64):
    arr = np.full((px, px, 3), value % 256, np.uint8)
    arr[0, :, 0] = np.arange(px) % 256  # a gradient row: resizes differ
    Image.fromarray(arr).save(path)


def _npz_equal(dir_a, dir_b, task):
    za = np.load(os.path.join(dir_a, f"task_{task}.npz"), allow_pickle=False)
    zb = np.load(os.path.join(dir_b, f"task_{task}.npz"), allow_pickle=False)
    assert set(za.files) == set(zb.files) == set(SPLITS)
    for k in SPLITS:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _task_data_equal(a, b):
    assert list(a.classes) == list(b.classes)
    for split in ("train", "val", "test"):
        sa, sb = getattr(a, split), getattr(b, split)
        np.testing.assert_array_equal(sa.images, sb.images)
        np.testing.assert_array_equal(sa.labels, sb.labels)


@pytest.fixture(autouse=True)
def port_config():
    tconfig.set_config(None)
    yield
    tconfig.set_config(None)


@pytest.fixture(scope="module")
def tiny_raw(tmp_path_factory):
    """Fake tiny-imagenet-200: every survey wnid with 5 train + 2 val
    images (64x64)."""
    root = tmp_path_factory.mktemp("tiny-imagenet-200")
    with open(ttiny.SURVEY_ORDER_FILE) as f:
        wnids = [line.strip() for line in f if line.strip()]
    with open(root / "wnids.txt", "w") as f:
        f.write("\n".join(sorted(wnids)))
    val_dir = root / "val" / "images"
    val_dir.mkdir(parents=True)
    ann = []
    for ci, wnid in enumerate(wnids):
        img_dir = root / "train" / wnid / "images"
        img_dir.mkdir(parents=True)
        for j in range(5):
            _write_png(img_dir / f"{wnid}_{j}.JPEG", ci * 5 + j)
        for j in range(2):
            fn = f"val_{ci * 2 + j}.JPEG"
            _write_png(val_dir / fn, ci)
            ann.append(f"{fn}\t{wnid}\t0\t0\t0\t0")
    with open(root / "val" / "val_annotations.txt", "w") as f:
        f.write("\n".join(ann))
    return root, wnids


@pytest.fixture(scope="module")
def tiny_prepared(tiny_raw, tmp_path_factory):
    """The 10-task split prepared by each package under its own root."""
    root, wnids = tiny_raw
    out = tmp_path_factory.mktemp("tiny_ds")
    jdir = jtiny.prepare(str(root), str(out / "jax"), task_count=10)
    tdir = ttiny.prepare(str(root), str(out / "port"), task_count=10)
    return out, jdir, tdir, wnids


def test_class_order_files_are_byte_identical():
    assert os.path.dirname(ttiny.SURVEY_ORDER_FILE) != os.path.dirname(
        jtiny.SURVEY_ORDER_FILE)
    assert filecmp.cmp(ttiny.SURVEY_ORDER_FILE, jtiny.SURVEY_ORDER_FILE,
                       shallow=False)


@pytest.mark.parametrize("task", [1, 5, 10])
def test_tiny_prepare_writes_the_same_arrays(tiny_prepared, task):
    _, jdir, tdir, wnids = tiny_prepared
    _npz_equal(jdir, tdir, task)
    z = np.load(os.path.join(tdir, f"task_{task}.npz"))
    assert [str(c) for c in z["classes"]] == wnids[(task - 1) * 20:
                                                   task * 20]
    assert z["train_images"].shape == (80, 64, 64, 3)


def test_tiny_each_package_reads_the_others_bundles(tiny_prepared):
    out, jdir, tdir, _ = tiny_prepared
    port_on_jax = ttiny.TinyImagenetSequence("tiny", ds_root=str(out / "jax"))
    jax_on_port = jtiny.TinyImagenetSequence("tiny", ds_root=str(out / "port"))
    for t in (1, 10):
        _task_data_equal(port_on_jax.get_task_dataset(t),
                         jax_on_port.get_task_dataset(t))
    assert port_on_jax.classes_per_task == jax_on_port.classes_per_task


def test_tiny_prepare_is_idempotent(tiny_prepared, tiny_raw):
    """A second ``prepare`` finds the token and writes nothing."""
    out, _, tdir, _ = tiny_prepared
    marker = os.path.join(tdir, "task_1.npz")
    mtime = os.path.getmtime(marker)
    assert os.path.isfile(os.path.join(tdir, ttiny.PREP_TOKEN))
    assert ttiny.prepare(str(tiny_raw[0]), str(out / "port"),
                         task_count=10) == tdir
    assert os.path.getmtime(marker) == mtime


def test_tiny_40_tasks_and_a_named_order(tiny_raw, tmp_path):
    """``tiny40`` (5 classes a task) and a ``tiny_<variant>`` ordering read
    from an order file: the same arrays and the same names in both."""
    root, wnids = tiny_raw
    for pkg, name in ((jtiny, "jax"), (ttiny, "port")):
        pkg.prepare(str(root), str(tmp_path / name), task_count=40)
    _npz_equal(str(tmp_path / "jax" / "tiny_40tasks"),
               str(tmp_path / "port" / "tiny_40tasks"), 40)
    seq = ttiny.TinyImagenetSequence("tiny40", ds_root=str(tmp_path / "port"))
    assert seq.task_count == 40 and seq.classes_per_task["40"] == 5

    order = tmp_path / "reversed.txt"
    order.write_text("\n".join(reversed(wnids)))
    dirs = [pkg.prepare(str(root), str(tmp_path / name), task_count=40,
                        order_file=str(order), variant="rev")
            for pkg, name in ((jtiny, "jax"), (ttiny, "port"))]
    _npz_equal(*dirs, 1)
    seq = ttiny.TinyImagenetSequence("tiny_rev", task_count=40,
                                     ds_root=str(tmp_path / "port"))
    assert seq.get_task_dataset(1).classes == wnids[::-1][:5]
    with pytest.raises(FileNotFoundError, match="order file"):
        ttiny.prepare(str(root), str(tmp_path / "x"), task_count=40,
                      order_file=str(tmp_path / "missing.txt"), variant="m")


def test_load_imagefolder_and_split_agree(tmp_path):
    """Class order, the min_images filter, the resize and the stratified
    split: the same arrays in both packages."""
    for cname, n in (("classA", 4), ("classB", 6), ("tiny", 1)):
        d = tmp_path / cname
        d.mkdir()
        for j in range(n):
            _write_png(d / f"{j}.png", 40 * len(cname) + j, px=48)
    got = timf.load_imagefolder(str(tmp_path), (32, 24), min_images=2)
    want = jimf.load_imagefolder(str(tmp_path), (32, 24), min_images=2)
    assert got[2] == want[2] == ["classA", "classB"]
    assert got[0].shape == (10, 32, 24, 3)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(timf.split_train_val(got[0], got[1], 0.25, seed=3),
                    jimf.split_train_val(want[0], want[1], 0.25, seed=3)):
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
    # a class_filter fixes the label space; a missing class raises in both
    filt = timf.load_imagefolder(str(tmp_path), (8, 8),
                                 class_filter=["classB", "classA"])
    assert filt[2] == ["classB", "classA"]
    assert list(np.bincount(filt[1])) == [6, 4]  # classB is label 0
    for imf in (timf, jimf):
        with pytest.raises(FileNotFoundError, match="missing"):
            imf.load_imagefolder(str(tmp_path), (8, 8),
                                 class_filter=["classA", "absent"])


def test_npz_member_shape_reads_the_header(tmp_path):
    sd = treg.SplitData(np.zeros((3, 5, 7, 3), np.uint8), np.zeros(3))
    path = timf.save_task_npz(str(tmp_path), 2, sd, sd, sd, ["a", "b"])
    for imf in (timf, jimf):
        assert imf.npz_member_shape(path, "train_images") == (3, 5, 7, 3)
        assert imf.npz_member_shape(path, "classes") == (2,)
    _task_data_equal(timf.load_task_npz(path), jimf.load_task_npz(path))


def _inat_raw(raw, species=("sp_a", "sp_b")):
    for sc in tinat.ORDER_UNREL:
        for k, sp in enumerate(species):
            d = raw / sc / sp
            d.mkdir(parents=True)
            for j in range(6):
                _write_png(d / f"{j}.png", 13 * len(sc) + 29 * k + j, px=20)
        rare = raw / sc / "sp_rare"  # below the filter: dropped
        rare.mkdir()
        _write_png(rare / "0.png", 7, px=20)


@pytest.mark.parametrize("order", ["unrel", "rel"])
def test_inaturalist_prepare_writes_the_same_arrays(tmp_path, monkeypatch,
                                                    order):
    for mod in (jinat, tinat):
        monkeypatch.setattr(mod, "MIN_IMAGES_PER_CLASS", 3)
        monkeypatch.setattr(mod, "IMG_SIZE", 16)
    _inat_raw(tmp_path / "raw")
    dirs = [mod.prepare(str(tmp_path / "raw"), str(tmp_path / name),
                        order=order, test_fraction=0.2, val_fraction=0.25)
            for mod, name in ((jinat, "jax"), (tinat, "port"))]
    for t in range(1, 11):
        _npz_equal(*dirs, t)
    name = "inat" if order == "unrel" else "inat_rel"
    seq = tinat.INaturalistSequence(name, ds_root=str(tmp_path / "jax"))
    ref = jinat.INaturalistSequence(name, ds_root=str(tmp_path / "port"))
    assert seq.ordering == ref.ordering
    assert seq.input_size == ref.input_size == (16, 16)
    assert seq.classes_per_task == ref.classes_per_task
    assert seq.class_count_list() == [2] * 10
    _task_data_equal(seq.get_task_dataset(3), ref.get_task_dataset(3))
    assert list(seq.get_task_dataset(1).classes) == ["sp_a", "sp_b"]


@pytest.mark.parametrize("name,want", [("inat", "unrel"),
                                       ("inat_unrel", "unrel"),
                                       ("inat_rel", "rel")])
def test_inat_ordering_suffix(tmp_path, name, want):
    """'unrel' ends with 'rel': the longer suffix is checked first, as in
    the JAX package; ``classes_per_task`` comes from the npz headers."""
    sd = treg.SplitData(np.zeros((2, 4, 4, 3), np.uint8), np.zeros(2))
    for order in ("rel", "unrel"):
        out = tmp_path / f"inaturalist_{order}_10tasks"
        timf.save_task_npz(str(out), 1, sd, sd, sd,
                           ["c0"] if order == "rel" else ["c0", "c1"])
    seq = treg.parse(name, ds_root=str(tmp_path))
    assert isinstance(seq, tinat.INaturalistSequence)
    assert seq.order == want == jinat.INaturalistSequence(
        name, ds_root=str(tmp_path)).order
    assert seq.classes_per_task[seq.get_taskname(1)] == (
        1 if want == "rel" else 2)
    assert seq.input_size == (4, 4)


def _recogseq_raw(raw):
    """Per dataset ``train``/``test`` ImageFolders, 2-4 classes a task; the
    test split lists its classes in another order than train."""
    for k, name in enumerate(trs.TASKS):
        for c in range(2 + (k % 3)):
            for split, n in (("train", 3), ("test", 10)):
                d = raw / name / split / f"cls{c}"
                d.mkdir(parents=True)
                for j in range(n):
                    _write_png(d / f"{j}.png", 10 * k + 3 * c + j, px=24)


def test_recogseq_prepare_writes_the_same_arrays(tmp_path, monkeypatch):
    """The 90/10 val/test carve of each dataset's test list and its
    class_filter; unequal class counts a task; each package reads the
    other's bundles."""
    for mod in (jrs, trs):
        monkeypatch.setattr(mod, "IMG_SIZE", 16)
    _recogseq_raw(tmp_path / "raw")
    dirs = [mod.prepare(str(tmp_path / "raw"), str(tmp_path / name))
            for mod, name in ((jrs, "jax"), (trs, "port"))]
    for t in range(1, 9):
        _npz_equal(*dirs, t)
    seq = treg.parse("recogseq", ds_root=str(tmp_path / "jax"))
    ref = jrs.RecogSeqSequence("recogseq", ds_root=str(tmp_path / "port"))
    assert isinstance(seq, trs.RecogSeqSequence)
    assert seq.class_count_list() == ref.class_count_list() == \
        [2, 3, 4, 2, 3, 4, 2, 3]
    assert seq.classes_per_task["birds"] == 4
    for t in (1, 8):
        td = seq.get_task_dataset(t)
        _task_data_equal(td, ref.get_task_dataset(t))
        n = len(td.classes)
        assert (td.train.size, td.val.size, td.test.size) == (3 * n, 9 * n,
                                                              n)
    assert trs.prepare(str(tmp_path / "raw"), str(tmp_path / "port")) == \
        dirs[1]


@pytest.mark.parametrize("name", ["tiny", "tiny40", "tiny_hardeasy"])
def test_parse_tiny_names(name, tmp_path):
    seq = treg.parse(name, ds_root=str(tmp_path))
    ref = jtiny.TinyImagenetSequence(name, ds_root=str(tmp_path))
    assert isinstance(seq, ttiny.TinyImagenetSequence)
    assert (seq.task_count, seq.input_size, seq._root) == (
        ref.task_count, ref.input_size, ref._root)
    with pytest.raises(FileNotFoundError, match="clsurvey_torch"):
        seq.get_task_dataset(1)


def test_parse_reads_ds_root_from_the_config(tmp_path, monkeypatch):
    """Without ``ds_root`` a sequence looks under the config's
    ``ds_root_path``, as the CLI's sequences do; unprepared roots and
    unknown names raise."""
    monkeypatch.setenv("CLSURVEY_ROOT", str(tmp_path))
    tconfig.set_config(None)
    root = tconfig.load_config(refresh=True).ds_root_path
    assert treg.parse("tiny")._root == os.path.join(root, "tiny_10tasks")
    for name in ("inat", "recogseq"):
        with pytest.raises(FileNotFoundError, match="prepare"):
            treg.parse(name)
    with pytest.raises(NotImplementedError, match="NOT IMPLEMENTED"):
        treg.parse("imagenet")
