"""The port's ZJU-MoCap loader (`keypointnerf_torch/data/zju.py`) and native
library (`data/native_loader.py`, built from native/kpnerf_data.cc)
against the JAX package's, on a fake tree (`data/fake_zju.py`): 21
cameras at 32² (16² after the 0.5 ratio), frames 0 and 30, frame 0's
images PNG and frame 30's JPEG, grey masks, `params/{frame}.npy` with
`Rh`; all written by imageio, which both loaders read through.

  * every field and `meta` of the train split over two epochs and of the
    test split bit-equal (the head pose within 1e-6: JAX takes
    cv2.Rodrigues, the port a numpy one);
  * the 313 / 315 naming (`Camera (i)/{frame}.jpg`), the same path lists,
    and missing files giving None on both sides;
  * get_rays_np, get_near_far_np, get_mask_at_box equal;
  * the library built from source bit-equal to the JAX package's; a
    failed build raises with the compiler's output, a missing compiler
    names it.

No JAX program is compiled: both loaders are numpy.
"""
import os

import numpy as np
import pytest

pytest.importorskip("torch")
imageio = pytest.importorskip("imageio.v2")

import keypointnerf_tpu.data.zju as jzju  # noqa: E402
from keypointnerf_tpu.data import native_loader as jnl  # noqa: E402

import keypointnerf_torch.data.zju as pzju  # noqa: E402
from keypointnerf_torch.data import native_loader as pnl  # noqa: E402
from keypointnerf_torch.data.fake_zju import write_fake_tree  # noqa: E402

HUMAN = "CoreView_377"
SPLIT = {HUMAN: {"begin_i": 0, "i_intv": 1, "ni": 2}}


def _imageio_write(path, img):
    imageio.imwrite(path, img)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zju"))
    write_fake_tree(root, [HUMAN], size=32, n_ims=4, image_exts=(".png", ".jpg"),
                    write_image=_imageio_write)
    return root


@pytest.fixture
def one_subject(monkeypatch):
    for mod in (jzju, pzju):
        monkeypatch.setattr(mod, "get_human_split", lambda split: dict(SPLIT))


def _assert_same_sample(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.keys() == b.keys()
    for k in a:
        if k == "meta":
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ma, mb = a["meta"], b["meta"]
    assert ma.keys() == mb.keys()
    for k in ma:
        if k == "headpose":
            np.testing.assert_allclose(ma[k], mb[k], rtol=0, atol=1e-6)
            assert ma[k].dtype == mb[k].dtype
        else:
            np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def test_train_split_two_epochs_equals_jax(tree, one_subject):
    jds, pds = jzju.ZJUDataset(tree, "train", seed=3), pzju.ZJUDataset(tree, "train", seed=3)
    assert pds.ims == jds.ims and pds.cam_inds == jds.cam_inds and len(pds) == 42
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        for i in range(len(pds)):
            a, b = pds[i], jds[i]
            assert a is not None
            _assert_same_sample(a, b)
    assert a["src_images"].shape == (3, 16, 16, 3) and a["src_masks"].shape == (3, 16, 16, 1)


def test_test_split_equals_jax(tree, one_subject):
    kw = dict(sample_frame=1, sample_camera=1)
    jds = jzju.ZJUTestDataset(tree, "test", **kw)
    pds = pzju.ZJUTestDataset(tree, "test", **kw)
    assert pds.ims == jds.ims and pds.cam_inds == jds.cam_inds and len(pds) == 12
    for i in range(len(pds)):
        a = pds[i]
        _assert_same_sample(a, jds[i])
        assert not np.allclose(a["meta"]["headpose"][:3, :3], np.eye(3))   # Rh read


def test_headpose_rodrigues_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for r in [np.zeros(3), np.array([np.pi, 0, 0])] + list(rng.uniform(-2, 2, (6, 3))):
        np.testing.assert_allclose(pzju.rodrigues(r), cv2.Rodrigues(r)[0], rtol=0, atol=1e-6)


def test_forced_jpg_naming_and_missing_files(tree, monkeypatch):
    """313 / 315 names map to `Camera (i)/{frame}.jpg` as in JAX; a sample
    whose files are missing is None on both sides."""
    human = "CoreView_313"
    os.makedirs(os.path.join(tree, human), exist_ok=True)
    annots = np.load(os.path.join(tree, HUMAN, "annots.npy"), allow_pickle=True).item()
    annots["ims"] = [{"ims": [f"Camera ({c + 1})/CoreView_313_Camera_({c + 1})_{fi:04d}_x.jpg"
                              for c in range(21)]} for fi in (1, 2)]
    np.save(os.path.join(tree, human, "annots.npy"), annots, allow_pickle=True)
    for mod in (jzju, pzju):
        monkeypatch.setattr(mod, "get_human_split",
                            lambda split: {human: {"begin_i": 0, "i_intv": 1, "ni": 2}})
    jds, pds = jzju.ZJUDataset(tree, "train"), pzju.ZJUDataset(tree, "train")
    assert pds.ims == jds.ims and pds.ims[0] == os.path.join(tree, human, "Camera (1)",
                                                             "0001.jpg")
    assert pds[0] is None and jds[0] is None
    for mod in (jzju, pzju):
        monkeypatch.setattr(mod, "get_human_split", lambda split: dict(SPLIT))
    jds, pds = jzju.ZJUDataset(tree, "train"), pzju.ZJUDataset(tree, "train")
    for ds in (jds, pds):
        ds.ims[0] = os.path.join(tree, HUMAN, "Camera_B1", "999999.png")
    assert pds[0] is None and jds[0] is None
    os.rename(os.path.join(tree, "_shared", "joints3d", "30.npy"),
              os.path.join(tree, "_shared", "joints3d", "30.off"))
    try:
        assert pds[len(pds) - 1] is None and jds[len(jds) - 1] is None
    finally:
        os.rename(os.path.join(tree, "_shared", "joints3d", "30.off"),
                  os.path.join(tree, "_shared", "joints3d", "30.npy"))


def test_ray_helpers_equal_jax():
    rng = np.random.default_rng(1)
    K = np.array([[40, 0, 16], [0, 42, 15], [0, 0, 1]], np.float32)
    R = pzju.rodrigues(rng.uniform(-1, 1, 3)).astype(np.float32)
    T = rng.uniform(-0.2, 0.2, (3, 1)).astype(np.float32) + np.array([[0], [0], [3]], np.float32)
    bounds = np.array([[-0.5, -0.6, -0.4], [0.5, 0.6, 0.45]], np.float32)
    for a, b in zip(pzju.get_rays_np(24, 32, K, R, T), jzju.get_rays_np(24, 32, K, R, T)):
        np.testing.assert_array_equal(a, b)
    ro, rd = jzju.get_rays_np(24, 32, K, R, T)
    ro, rd = ro.reshape(-1, 3).astype(np.float32), rd.reshape(-1, 3).astype(np.float32)
    for a, b in zip(pzju.get_near_far_np(bounds, ro, rd), jzju.get_near_far_np(bounds, ro, rd)):
        np.testing.assert_array_equal(a, b)
    got = pzju.get_mask_at_box(bounds, K, R, T, 24, 32)
    np.testing.assert_array_equal(got, jzju.get_mask_at_box(bounds, K, R, T, 24, 32))
    assert 0 < got.sum() < got.size


def test_native_library_built_from_source_equals_jax():
    """The port builds native/kpnerf_data.cc into build/native/ (never the
    committed library) and its operations equal the JAX package's."""
    if not jnl.available():
        pytest.skip("the JAX package's native library is unavailable")
    assert pnl.build() == pnl.LIB_PATH and os.path.exists(pnl.LIB_PATH)
    assert os.path.dirname(str(pnl.LIB_PATH)).endswith(os.path.join("build", "native"))
    rng = np.random.default_rng(2)
    img = rng.random((37, 41, 3)).astype(np.float32)
    K = np.array([[50, 0, 20], [0, 52, 18], [0, 0, 1]], np.float32)
    dist = np.array([-0.2, 0.05, 0.001, -0.001, 0.01], np.float32)
    np.testing.assert_array_equal(pnl.undistort(img, K, dist), jnl.undistort(img, K, dist))
    np.testing.assert_array_equal(pnl.undistort(img[..., 0], K, dist),
                                  jnl.undistort(img[..., 0], K, dist))
    for dh, dw in ((18, 20), (13, 29)):
        np.testing.assert_array_equal(pnl.resize_area(img, dh, dw), jnl.resize_area(img, dh, dw))
        np.testing.assert_array_equal(pnl.resize_nearest(img, dh, dw),
                                      jnl.resize_nearest(img, dh, dw))
    mask = (rng.random((37, 41)) > 0.5).astype(np.float32)
    for a, b in zip(pnl.mask_apply(img.copy(), mask), jnl.mask_apply(img.copy(), mask)):
        np.testing.assert_array_equal(a, b)
    got = dict(pnl.ordered(lambda i: (i, i * i), [3, 1, 3, 2], n_threads=2))
    assert got == {3: 9, 1: 1, 2: 4}


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int kp_bad( {\n")
    with pytest.raises(RuntimeError, match=r"(?s)building bad\.cc failed.*error"):
        pnl.build_library(bad, tmp_path / "libbad.so", ("-fPIC", "-shared"))
    assert not (tmp_path / "libbad.so").exists()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        pnl.build_library(bad, tmp_path / "libbad.so", ("-fPIC", "-shared"))
    assert not pnl.links_openmp()
