"""No JAX in a run: the harness and the program load none of jax, jaxlib,
flax or the JAX package (whole top-level names), and the reference loads
nothing of the program; the check that refuses a run finds one planted."""
import subprocess
import sys

from harness import spec

BANNED = ("jax", "jaxlib", "flax", "keypointnerf_tpu")


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({n.split('.')[0]"
                          " for n in sys.modules}))"], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True, env={"PYTHONPATH": f"{spec.BENCH_DIR}:{spec.ROOT}",
                                                     "PATH": "/usr/bin:/bin"})
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_and_program_load_no_jax():
    mods = loaded("import run\nfrom harness import cell, control, trace\n"
                  "import keypointnerf_torch.render, keypointnerf_torch.training")
    assert not set(mods) & set(BANNED)
    assert "keypointnerf_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = loaded("from reference import model, render, train, params, precision")
    assert "keypointnerf_torch" not in mods and not set(mods) & set(BANNED)


def test_the_check_names_whole_top_level_names():
    from harness.cell import sys_modules_banned

    assert sys_modules_banned() == []
    sys.modules["keypointnerf_tpu_like"] = sys          # a longer name is not the package
    sys.modules["flax.linen"] = sys
    try:
        assert sys_modules_banned() == ["flax"]
    finally:
        del sys.modules["keypointnerf_tpu_like"], sys.modules["flax.linen"]
