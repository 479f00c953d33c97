"""Nothing the benchmark runs on the card imports JAX or the JAX package; the
plain reference imports nothing of the program; without a card a run exits
non-zero and prints no result."""
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

PROBE = r"""
import glob, importlib.util, json, os, sys
sys.path.insert(0, {bench!r})
{imports}
tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def top_modules(imports: str):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", PROBE.format(bench=BENCH, imports=imports)],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_metrics_import_no_jax():
    imports = """
import run, control
from harness import card, check, data, port, readers, spec, trace, weights, work
port.sam_config  # the port's modules load at a run's first build
import micro_sam_tpu_torch.predictor, micro_sam_tpu_torch.util, micro_sam_tpu_torch.models.build_sam
for i, f in enumerate(sorted(glob.glob(os.path.join({bench!r}, "drivers", "*.py"))
                      + glob.glob(os.path.join({bench!r}, "metrics", "*.py")))):
    run.load_file(f, "probe_%d" % i)
""".format(bench=BENCH)
    tops = top_modules(imports)
    assert "micro_sam_tpu_torch" in tops  # the port passes: its name is compared whole
    assert not tops & {"jax", "jaxlib", "flax", "micro_sam_tpu"}


def test_reference_imports_nothing_of_the_program():
    tops = top_modules("import reference.sam, harness.weights")
    assert not tops & {"jax", "jaxlib", "flax", "micro_sam_tpu", "micro_sam_tpu_torch"}


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the machine holds
    return subprocess.run([sys.executable, "gpubench/run.py", *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


def test_a_run_without_a_card_prints_no_result():
    out = _run(ROOT, "--workload", "vit_h.embed_b8", "--seed", str(2 ** 31 + 7), "--seconds",
               "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_a_run_beside_no_program_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path), "--workload", "vit_b.embed_b8", "--seed", "3", "--seconds", "1",
               "--trace", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
