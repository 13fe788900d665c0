"""The traffic is a function of the seed: the same seed gives the same
subjects, order, orbit and draws; another seed other ones. The rig is the
program's synthetic rig, copied."""
import numpy as np
import torch

from bench_toy import cpu
from harness import scene, spec, traffic

MIX = {"kind": "frames", "image_size": 32, "frame_size": 32, "views": 4, "subjects": 3,
       "frames_per_subject": 5, "degrees_per_frame": 6.0, "radius": 3.5, "elevation": 0.05}
M = spec.data("configs", "zju")["model"]


def same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_subjects_follow_the_seed():
    seed = 2**31 + 12345
    a, b = traffic.subjects(MIX, seed, cpu()), traffic.subjects(MIX, seed, cpu())
    c = traffic.subjects(MIX, seed + 1, cpu())
    assert all(same(x, y) for x, y in zip(a, b))
    assert not same(a[0], c[0])
    assert (traffic.order(MIX, seed, 10) == traffic.order(MIX, seed, 10)).all()
    assert sorted(traffic.order(MIX, seed, 3)) == [0, 1, 2]
    assert (traffic.orbit_starts(MIX, seed) == traffic.orbit_starts(MIX, seed)).all()
    assert traffic.sampled(seed, "x", 3, 10) == traffic.sampled(seed, "x", 3, 10)


def test_draws_follow_the_seed():
    pool = traffic.fg_pixels(traffic.subjects(MIX, 7, cpu())[0])
    a = traffic.train_draws(M, 4, pool, 7, 3)
    b = traffic.train_draws(M, 4, pool, 7, 3)
    c = traffic.train_draws(M, 4, pool, 7, 4)
    flat = lambda d: [d["patch_index"], d["strat_u"], d["importance_u"], d["coarse"]["noise"],  # noqa
                      d["fine"]["view_keep"]]
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["strat_u"], c["strat_u"])
    assert a["coarse"]["view_keep"].sum() >= 1 and int(a["patch_index"]) in set(pool.tolist())


def test_rig_is_the_programs():
    from keypointnerf_torch.data import SyntheticConfig, make_sample

    ref = make_sample(SyntheticConfig(image_size=48, n_views=4), seed=9)
    got = scene.make_subject(np.random.default_rng(9), 48, 4, cpu())
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5)  # float64 sums in another order
