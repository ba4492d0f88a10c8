"""The port's data layer (`hitadv_torch.data`, `hitadv_torch.runtime`) and
its datasets through `hitadv_torch.eval.main`, against the JAX package's
on the CPU.

Every file is written here from numpy seeds, in the published layouts
(`modelnet40_normal_resampled` txt, ShapeNetPart's txt and json splits,
the DGCNN-style h5 files, ScanNet's pickles). Loaders, augmentations
and the native parser are numpy on both sides: their arrays must be
equal bit for bit.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest

from hitadv_tpu import data as JD
from hitadv_tpu import runtime as JR
from hitadv_tpu.data import provider as JP
from hitadv_torch import data as D
from hitadv_torch import eval as EV
from hitadv_torch import runtime as R
from hitadv_torch.data import provider as P

PKL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "asr_victim_params.pkl")


def _equal(a, b):
    """Two items (arrays, ints or tuples of them) equal bit for bit, with
    the same dtypes."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def _write_modelnet(root, clouds, labels, names, prefix="modelnet40"):
    """A `modelnet40_normal_resampled` tree: one comma-separated txt file
    of 6 columns a cloud, the catalog and the test split (in the order of
    ``clouds``), an empty train split."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, f"{prefix}_shape_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    ids = []
    for i, (pts, lab) in enumerate(zip(clouds, labels)):
        name = names[int(lab)]
        os.makedirs(os.path.join(root, name), exist_ok=True)
        sid = f"{name}_{i:04d}"
        ids.append(sid)
        np.savetxt(os.path.join(root, name, sid + ".txt"), pts,
                   delimiter=",", fmt="%.6f")
    with open(os.path.join(root, f"{prefix}_test.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    with open(os.path.join(root, f"{prefix}_train.txt"), "w") as f:
        f.write("")
    return str(root)


@pytest.fixture(scope="module")
def modelnet_root(tmp_path_factory):
    """Nine clouds of 300 x 6 rows over three classes."""
    rng = np.random.RandomState(0)
    clouds = rng.randn(9, 300, 6).astype(np.float32)
    return _write_modelnet(tmp_path_factory.mktemp("mn") / "root", clouds,
                           [0, 1, 2] * 3, ["airplane", "bed", "chair"])


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    """ShapeNetPart's layout: three categories, whitespace txt files of
    xyz, normal and part label, the json splits."""
    rng = np.random.RandomState(1)
    root = tmp_path_factory.mktemp("snp")
    cats = {"Airplane": "02691156", "Chair": "03001627",
            "Table": "04379243"}
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{k}\t{v}\n" for k, v in cats.items()))
    lists = {"train": [], "val": [], "test": []}
    for j, offset in enumerate(cats.values()):
        (root / offset).mkdir()
        for i in range(4):
            n = 200 + 37 * i + j
            rows = np.concatenate(
                [rng.randn(n, 6), rng.randint(0, 4, (n, 1))], 1)
            np.savetxt(root / offset / f"s{j}{i}.txt", rows, fmt="%.5f")
            split = ("test", "test", "train", "val")[i]
            lists[split].append(f"shape_data/{offset}/s{j}{i}")
    (root / "train_test_split").mkdir()
    for split, lst in lists.items():
        (root / "train_test_split"
         / f"shuffled_{split}_file_list.json").write_text(json.dumps(lst))
    return str(root)


def _items(ds, n=None):
    return [ds[i] for i in range(len(ds) if n is None else n)]


@pytest.mark.parametrize("uniform,use_normals", [
    (False, True), (False, False), (True, True)])
def test_modelnet_dataset_matches_jax(modelnet_root, uniform, use_normals):
    """Take-first and `uniform` (per-cloud FPS whose start comes from the
    global ``np.random``, pinned by a seed on both sides) with and
    without normals: every cloud and label bit for bit."""
    kw = dict(num_points=128, split="test", use_normals=use_normals,
              uniform=uniform)
    np.random.seed(7)
    want = _items(JD.ModelNetDataset(modelnet_root, **kw))
    np.random.seed(7)
    got = _items(D.ModelNetDataset(modelnet_root, **kw))
    assert len(got) == 9 and got[0][0].shape == (128, 6 if use_normals
                                                 else 3)
    for a, b in zip(got, want):
        _equal(a, b)


def test_modelnet_process_data_cache_matches_jax(modelnet_root, tmp_path):
    """``process_data``: the port writes its pickle cache under the JAX
    package's name, reads it back on the next construction, and either
    package's cache gives the other's clouds."""
    mine = str(tmp_path / "mine")
    shutil.copytree(modelnet_root, mine)
    kw = dict(num_points=100, split="test", process_data=True)
    first = D.ModelNetDataset(mine, **kw)
    want = JD.ModelNetDataset(modelnet_root, **kw)
    assert os.path.basename(first.save_path) == \
        os.path.basename(want.save_path) == "modelnet40_test_100pts.dat"
    assert os.path.exists(first.save_path)
    again = D.ModelNetDataset(mine, **kw)
    from_jax = D.ModelNetDataset(modelnet_root, **kw)
    for items in (_items(first), _items(again), _items(from_jax)):
        for a, b in zip(items, _items(want)):
            _equal(a, b)
    os.remove(want.save_path)


def test_modelnet_native_parser_matches_jax(modelnet_root):
    """The dataset's ``parser=`` hook with each package's native parser,
    and without one: the same clouds bit for bit."""
    kw = dict(num_points=256, split="test")
    want = _items(JD.ModelNetDataset(modelnet_root, parser=JR.NativeParser(),
                                     **kw))
    for parser in (R.NativeParser(), None):
        got = _items(D.ModelNetDataset(modelnet_root, parser=parser, **kw))
        for a, b in zip(got, want):
            _equal(a, b)


def test_native_parser_matches_jax_and_loadtxt(modelnet_root):
    """`NativeParser.load_txt` and `load_batch` (truncating, and with its
    normalisation) against the JAX package's parser, and `load_txt`
    against ``np.loadtxt``: bit for bit. The port's library is built
    under the kernels' build directory, named by its source's hash."""
    paths = sorted(
        os.path.join(dp, f) for dp, _, fs in os.walk(modelnet_root)
        for f in fs if f.endswith(".txt") and "_" in f
        and not f.startswith("modelnet"))
    mine, ref = R.NativeParser(max_rows=1000), JR.NativeParser(max_rows=1000)
    for p in paths:
        got = mine.load_txt(p)
        _equal(got, ref.load_txt(p))
        _equal(got, np.loadtxt(p, delimiter=",").astype(np.float32))
    for normalize in (False, True):
        _equal(mine.load_batch(paths, 256, normalize=normalize),
               ref.load_batch(paths, 256, normalize=normalize))
    assert R.available()
    lib = R.library_path()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "ops"
    assert lib.exists()


@pytest.mark.parametrize("class_choice,normal_channel", [
    (None, True), (["Chair"], False), (None, False)])
def test_part_normal_dataset_matches_jax(shapenet_root, class_choice,
                                         normal_channel):
    """`PartNormalDataset` on each split, with its ``RandomState(0)``
    resample drawn anew on every access (each index read twice: the
    second from the cache): bit for bit."""
    for split in ("test", "trainval", "train"):
        kw = dict(npoints=256, split=split, class_choice=class_choice,
                  normal_channel=normal_channel)
        jds, ds = JD.PartNormalDataset(shapenet_root, **kw), \
            D.PartNormalDataset(shapenet_root, **kw)
        assert len(ds) == len(jds) > 0
        order = list(range(len(ds))) * 2
        for i in order:
            _equal(ds[i], jds[i])


def test_part_normal_dataset_unknown_split(shapenet_root):
    for mod in (D, JD):
        with pytest.raises(ValueError, match="unknown split"):
            mod.PartNormalDataset(shapenet_root, split="dev")


@pytest.fixture(scope="module")
def h5_root(tmp_path_factory):
    """The DGCNN-style h5 files: ModelNet40 (train and test), the
    ShapeNetPart segmentation files (train, val, test), S3DIS with its
    file list, and ScanNet's two pickles."""
    import h5py

    rng = np.random.RandomState(2)
    root = tmp_path_factory.mktemp("h5")
    for part, n in (("train", 5), ("test", 4)):
        d = root / "modelnet40_ply_hdf5_2048"
        d.mkdir(exist_ok=True)
        for k in range(2):
            with h5py.File(d / f"ply_data_{part}{k}.h5", "w") as f:
                f["data"] = rng.randn(n, 300, 3).astype(np.float32)
                f["label"] = rng.randint(0, 40, (n, 1)).astype(np.uint8)
    seg = root / "shapenet_part_seg_hdf5_data"
    seg.mkdir()
    for part in ("train0", "val0", "test0"):
        with h5py.File(seg / f"ply_data_{part}.h5", "w") as f:
            f["data"] = rng.randn(6, 256, 3).astype(np.float32)
            f["label"] = (np.arange(6)[:, None] % 4).astype(np.uint8)
            f["pid"] = rng.randint(0, 50, (6, 256)).astype(np.uint8)
    s3 = root / "indoor3d_sem_seg_hdf5_data"
    s3.mkdir()
    names = []
    for k in range(2):
        name = f"ply_data_all_{k}.h5"
        with h5py.File(s3 / name, "w") as f:
            f["data"] = rng.rand(3, 512, 9).astype(np.float32)
            f["label"] = rng.randint(0, 13, (3, 512)).astype(np.uint8)
        names.append(f"indoor3d_sem_seg_hdf5_data/{name}")
    (s3 / "all_files.txt").write_text("\n".join(names) + "\n")
    scan = root / "scannet"
    scan.mkdir()
    rooms = [np.concatenate([rng.rand(n, 2) * 4, rng.rand(n, 1),
                             rng.rand(n, 3)], 1).astype(np.float32)
             for n in (3000, 2200)]
    labels = [rng.randint(0, 21, len(r)).astype(np.int32) for r in rooms]
    with open(scan / "scannet_train_rgb21c_pointid.pickle", "wb") as f:
        pickle.dump(rooms, f)
        pickle.dump(labels, f)
    return root


@pytest.mark.parametrize("which", [
    "modelnet40_train", "modelnet40_test", "partseg_trainval",
    "partseg_test_car", "s3dis_train", "s3dis_test", "scannet_rgb",
    "scannet_xyz"])
def test_h5_datasets_match_jax(h5_root, which):
    """The four h5 datasets (and ScanNet's pickle-fed block sampler) with
    their ``RandomState(0)`` augmentations and resamples: every item bit
    for bit, and the loaded arrays too."""
    mn = str(h5_root / "modelnet40_ply_hdf5_2048")
    seg = str(h5_root / "shapenet_part_seg_hdf5_data")
    s3 = str(h5_root / "indoor3d_sem_seg_hdf5_data")
    scan = str(h5_root / "scannet")
    make = {
        "modelnet40_train": lambda M: M.ModelNet40H5(mn, 256, "train"),
        "modelnet40_test": lambda M: M.ModelNet40H5(mn, 200, "test"),
        "partseg_trainval": lambda M: M.ShapeNetPartH5(seg, 200,
                                                       "trainval"),
        "partseg_test_car": lambda M: M.ShapeNetPartH5(
            seg, 256, "test", class_choice="car"),
        "s3dis_train": lambda M: M.S3DISH5(s3, 400, "train"),
        "s3dis_test": lambda M: M.S3DISH5(s3, 512, "test"),
        "scannet_rgb": lambda M: M.ScanNetBlocks(scan, 1024, "train",
                                                 use_rgb=True),
        "scannet_xyz": lambda M: M.ScanNetBlocks(scan, 700, "train",
                                                 block_size=1.0,
                                                 sample_rate=0.5),
    }[which]
    jds, ds = make(JD), make(D)
    assert len(ds) == len(jds) > 0
    for i in list(range(len(ds))) * 2:
        _equal(tuple(ds[i]) if isinstance(ds[i], tuple) else ds[i],
               tuple(jds[i]) if isinstance(jds[i], tuple) else jds[i])
    for attr in ("data", "label", "seg", "room_idxs"):
        if hasattr(jds, attr):
            _equal(getattr(ds, attr), getattr(jds, attr))


def test_h5_loaders_match_jax(h5_root):
    """`load_h5_cls`, `load_data_partseg` (each partition) and
    `load_data_semseg`, and the missing-file error."""
    mn = str(h5_root / "modelnet40_ply_hdf5_2048")
    seg = str(h5_root / "shapenet_part_seg_hdf5_data")
    s3 = str(h5_root / "indoor3d_sem_seg_hdf5_data")
    for part in ("train", "test"):
        _equal(D.load_h5_cls(mn, part), JD.load_h5_cls(mn, part))
    for part in ("train", "trainval", "test"):
        _equal(D.load_data_partseg(seg, part), JD.load_data_partseg(seg, part))
    _equal(D.load_data_semseg(s3), JD.load_data_semseg(s3))
    with pytest.raises(FileNotFoundError):
        D.load_h5_cls(mn, "val")


def _provider_cases():
    """(name, arguments but the generator): every augmentation of
    `provider`; the ones that draw take ``rng=``."""
    x = np.random.RandomState(3).randn(4, 64, 3).astype(np.float32) * 2
    xn = np.random.RandomState(4).randn(4, 64, 6).astype(np.float32)
    one = x[0]
    labels = np.arange(4)
    return [
        ("normalize_data", (x,), False),
        ("shuffle_data", (x, labels), True),
        ("shuffle_points", (x,), True),
        ("rotate_point_cloud", (x,), True),
        ("rotate_point_cloud_z", (x,), True),
        ("rotate_point_cloud_with_normal", (xn,), True),
        ("rotate_perturbation_point_cloud", (x,), True),
        ("rotate_perturbation_point_cloud_with_normal", (xn,), True),
        ("rotate_point_cloud_by_angle", (x, 0.7), False),
        ("rotate_point_cloud_by_angle_with_normal", (xn, -1.3), False),
        ("jitter_point_cloud", (x,), True),
        ("shift_point_cloud", (x,), True),
        ("random_scale_point_cloud", (x,), True),
        ("random_point_dropout", (x,), True),
        ("translate_pointcloud", (one,), True),
        ("jitter_pointcloud", (one,), True),
        ("rotate_pointcloud", (one,), True),
    ]


@pytest.mark.parametrize("case", _provider_cases(), ids=lambda c: c[0])
def test_provider_matches_jax(case):
    """Each augmentation on the same input and seed, through ``rng=`` and
    through the global ``np.random`` (seeded alike): bit for bit."""
    name, args, draws = case
    if not draws:
        _equal(getattr(P, name)(*args), getattr(JP, name)(*args))
        return
    _equal(getattr(P, name)(*args, rng=np.random.RandomState(11)),
           getattr(JP, name)(*args, rng=np.random.RandomState(11)))
    np.random.seed(12)
    got = getattr(P, name)(*args)
    np.random.seed(12)
    _equal(got, getattr(JP, name)(*args))


def test_provider_has_every_function():
    public = {n for n in dir(JP) if not n.startswith("_")
              and callable(getattr(JP, n)) and n not in ("Optional",
                                                          "Tuple")}
    assert public <= {c[0] for c in _provider_cases()}
    assert public <= set(dir(P))


@pytest.mark.parametrize("num_workers", [0, 4])
def test_batch_iterator_matches_jax(modelnet_root, num_workers):
    """The ordered batches, serial and on four loader threads, with a
    partial last batch, shuffled by a seeded generator: equal to the JAX
    iterator's serial ones, bit for bit."""
    kw = dict(num_points=64, split="test")
    want = list(JD.batch_iterator(JD.ModelNetDataset(modelnet_root, **kw),
                                  4, shuffle=True,
                                  rng=np.random.RandomState(3)))
    got = list(D.batch_iterator(D.ModelNetDataset(modelnet_root, **kw), 4,
                                shuffle=True, rng=np.random.RandomState(3),
                                num_workers=num_workers))
    assert [len(b[1]) for b in got] == [4, 4, 1]
    for a, b in zip(got, want):
        _equal(a, b)
    assert len(list(D.batch_iterator(D.ModelNetDataset(modelnet_root, **kw),
                                     4, drop_last=True,
                                     num_workers=num_workers))) == 2


def test_batch_iterator_forwards_worker_errors(modelnet_root):
    """A loader thread's exception reaches the consumer, in order."""
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise KeyError("cloud 4")
            return np.zeros((2, 3), np.float32), i

    it = D.batch_iterator(Broken(), 2, num_workers=3)
    assert [list(b[1]) for b in (next(it), next(it))] == [[0, 1], [2, 3]]
    with pytest.raises(KeyError, match="cloud 4"):
        next(it)


def test_device_put_batches_copies_to_the_device():
    pts = np.random.RandomState(0).randn(2, 5, 6).astype(np.float64)
    labels = np.array([3, 1], np.int32)
    (p, lab), = D.device_put_batches([(pts, labels)], "cpu")
    assert p.dtype.is_floating_point and str(p.dtype) == "torch.float32"
    assert str(lab.dtype) == "torch.int64" and lab.tolist() == [3, 1]
    np.testing.assert_array_equal(p.numpy(), pts.astype(np.float32))


@pytest.fixture(scope="module")
def trained_modelnet(tmp_path_factory):
    """32 clouds of the trained 10-class victim's kind (64 points,
    synthetic seed 99) written as a 10-category ModelNet tree in the
    published layout, the labels by the catalog's order."""
    from hitadv_tpu.data import synthetic_clouds

    pts, labels = synthetic_clouds(32, 64, num_classes=10, seed=99)
    return _write_modelnet(tmp_path_factory.mktemp("mn10") / "root", pts,
                           labels, [f"class{i}" for i in range(10)],
                           prefix="modelnet10")


@pytest.mark.parametrize("attack,extra", [
    ("IFGSM", ["--num_iter", "10"]),
    ("HiT-ADV", ["--binary_step", "2", "--num_iter", "8", "--central_num",
                 "16", "--total_central_num", "24", "--curv_loss_knn",
                 "8"])])
def test_main_on_modelnet_matches_jax_main(trained_modelnet, attack, extra):
    """`hitadv_torch.eval.main` with ``--dataset ModelNet`` on the trained
    victim (two batches of 16, four loader threads) against the JAX
    package's `main` on the same arguments: the same clean-correct
    clouds, and ASR within one example (the two draw their random starts
    from different generators)."""
    from hitadv_tpu.eval import main as jax_main
    from hitadv_tpu.ops import geometry as JG

    argv = ["--dataset", "ModelNet", "--data_path", trained_modelnet,
            "--num_category", "10", "--num_class", "10", "--batch_size",
            "16", "--num_point", "64", "--num_workers", "4",
            "--checkpoint", PKL, "--seed", "99", "--budget", "0.2",
            "--log_dir", "", "--attack_type", attack] + extra
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        want = jax_main(argv)
    finally:
        JG.set_backend(prev)
    got = EV.main(argv + ["--device", "cpu"])
    assert got["total"] == want["total"] == 32
    assert got["clean_correct"] == want["clean_correct"] > 0
    assert abs(got["asr"] - want["asr"]) * want["clean_correct"] <= 1 + 1e-6
    for key in ("knn_dist", "uniform_dist", "curv_std_dist"):
        assert np.isfinite(got[key]), key


@pytest.mark.parametrize("dataset", ["ModelNet", "ShapeNetPart"])
def test_missing_data_path_raises(dataset):
    """A real dataset without ``--data_path`` raises (the JAX `eval` runs
    synthetic clouds instead: a deliberate difference)."""
    with pytest.raises(ValueError, match="--data_path"):
        EV.main(["--dataset", dataset, "--device", "cpu", "--log_dir", ""])


def test_main_on_shapenet_part_runs(shapenet_root):
    """``--dataset ShapeNetPart`` through `main`: its two test clouds a
    category, resampled to 64 points with normals."""
    m = EV.main(["--dataset", "ShapeNetPart", "--data_path", shapenet_root,
                 "--batch_size", "3", "--num_point", "64", "--num_class",
                 "16", "--attack_type", "FGSM", "--budget", "0.1",
                 "--device", "cpu", "--log_dir", "", "--num_workers", "2"])
    assert m["total"] == 6
    for key in ("asr", "knn_dist", "uniform_dist", "curv_std_dist"):
        assert np.isfinite(m[key]) or (key == "asr" and
                                       m["clean_correct"] == 0), key
