"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's)."""
import subprocess
import sys

from portbench.run import FORBIDDEN, forbidden_modules, ROOT


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["slam_dynamic_tpu_torch",
                              "slam_dynamic_tpu_torch.system",
                              "jaxtyping", "flaxen.x"]) == []
    assert forbidden_modules(["slam_dynamic_tpu.io.synthetic",
                              "jax.numpy", "jaxlib", "flax.linen",
                              "torch"]) == sorted(FORBIDDEN)


def test_the_harness_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import portbench.run, portbench.calibrate, portbench.drive\n"
        "import portbench.world, portbench.reference, portbench.trace\n"
        "import portbench.record, portbench.faults, portbench.peaks\n"
        "from portbench import spec\n"
        "b = spec.load_benchmark()\n"
        "for m in b['per_layer']: spec.load_reader(m['name'])\n"
        "import slam_dynamic_tpu_torch.system\n"
        "import slam_dynamic_tpu_torch.parallel.multi_system\n"
        "print(portbench.run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\nimport portbench.reference, portbench.peaks\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('slam')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _command(cwd):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "euroc-stereo.v1.frame", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_or_the_program_no_result_is_printed(tmp_path):
    import shutil
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
