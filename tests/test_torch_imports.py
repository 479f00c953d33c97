"""The port stands alone: it imports torch, never jax, and nothing of the JAX
package (micro_sam_tpu), and neither does chip_smoke.py."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "micro_sam_tpu_torch")

# "micro_sam_tpu" followed by a non-word character (or the end): the port's
# own name, micro_sam_tpu_torch, does not match
_JAX_PKG = r"micro_sam_tpu(?=\W|$)"
_IMPORT_RE = re.compile(
    rf"^\s*(from\s+({_JAX_PKG}|jax)(?=[\s.])|import\s+({_JAX_PKG}|jax)(?=[\s.,]|$))"
    rf"|import_module\(\s*['\"]({_JAX_PKG}|jax)(?=[.'\"])", re.M)


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_scan_pattern_tells_the_packages_apart():
    assert _IMPORT_RE.search("from micro_sam_tpu.util import x")
    assert _IMPORT_RE.search("import micro_sam_tpu")
    assert _IMPORT_RE.search("    import jax.numpy as jnp")
    assert _IMPORT_RE.search("importlib.import_module('micro_sam_tpu.ops')")
    assert not _IMPORT_RE.search("from micro_sam_tpu_torch.util import x")
    assert not _IMPORT_RE.search("import micro_sam_tpu_torch")
    assert not _IMPORT_RE.search("# see micro_sam_tpu/ops/fused_window_block.py")


def test_no_jax_or_jax_package_import_in_port_sources():
    hits = []
    for path in _sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if _IMPORT_RE.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{n}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_no_networkx_import_in_port_sources():
    """The GPU machine has no networkx: the port finds its lineage components
    itself (multi_dimensional_segmentation._connected_components)."""
    pattern = re.compile(r"^\s*(from\s+networkx(?=[\s.])|import\s+networkx(?=[\s.,]|$))", re.M)
    assert pattern.search("    import networkx as nx") and not pattern.search("# networkx")
    hits = []
    for path in _sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pattern.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{n}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import micro_sam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'micro_sam_tpu' or m.startswith('micro_sam_tpu.')\n"
        "             or m == 'networkx')\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "new = {'micro_sam_tpu_torch.training', 'micro_sam_tpu_torch.training.sam_trainer',\n"
        "       'micro_sam_tpu_torch.training.trainable_sam', 'micro_sam_tpu_torch.training.util',\n"
        "       'micro_sam_tpu_torch.training.training', 'micro_sam_tpu_torch.prompt_generators',\n"
        "       'micro_sam_tpu_torch.sample_data', 'micro_sam_tpu_torch.ops.amg_utils',\n"
        "       'micro_sam_tpu_torch.models.tiny_vit', 'micro_sam_tpu_torch.ops.dwconv',\n"
        "       'micro_sam_tpu_torch.ops.tiny_attention', 'micro_sam_tpu_torch.ops.fused_mbconv',\n"
        "       'micro_sam_tpu_torch.ops.fused_tiny_attention',\n"
        "       'micro_sam_tpu_torch.ops.fused_tiny_tail',\n"
        "       'micro_sam_tpu_torch.multi_dimensional_segmentation',\n"
        "       'micro_sam_tpu_torch.learned_tracking',\n"
        "       'micro_sam_tpu_torch.training.joint_sam_trainer',\n"
        "       'micro_sam_tpu_torch.training.simple_sam_trainer',\n"
        "       'micro_sam_tpu_torch.training.semantic_sam_trainer',\n"
        "       'micro_sam_tpu_torch.evaluation', 'micro_sam_tpu_torch.evaluation.matching',\n"
        "       'micro_sam_tpu_torch.evaluation.experiments',\n"
        "       'micro_sam_tpu_torch.evaluation.evaluation',\n"
        "       'micro_sam_tpu_torch.evaluation.inference',\n"
        "       'micro_sam_tpu_torch.evaluation.instance_segmentation',\n"
        "       'micro_sam_tpu_torch.evaluation.multi_dimensional_segmentation',\n"
        "       'micro_sam_tpu_torch.evaluation.livecell',\n"
        "       'micro_sam_tpu_torch.evaluation.benchmark_datasets',\n"
        "       'micro_sam_tpu_torch.evaluation.model_comparison',\n"
        "       'micro_sam_tpu_torch.visualization', 'micro_sam_tpu_torch.object_classification',\n"
        "       'micro_sam_tpu_torch.info', 'micro_sam_tpu_torch.parallel',\n"
        "       'micro_sam_tpu_torch.parallel.mesh', 'micro_sam_tpu_torch.parallel.embed',\n"
        "       'micro_sam_tpu_torch.parallel.decode',\n"
        "       'micro_sam_tpu_torch.parallel.train_step',\n"
        "       'micro_sam_tpu_torch.parallel.distributed'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_modules_import_without_the_optional_libraries():
    """The GPU machine has none of pandas, imageio, h5py, sklearn, matplotlib,
    xxhash or joblib: every module of the port imports with them blocked
    (the functions that need one import it at the call)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "BLOCK = {'pandas', 'imageio', 'h5py', 'sklearn', 'matplotlib', 'xxhash', 'joblib',\n"
        "         'jax', 'networkx'}\n"
        "class Blocker:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCK:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Blocker())\n"
        "import micro_sam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'micro_sam_tpu_torch.evaluation.model_comparison' in names, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_export_and_annotator_modules_import_without_gui_or_onnx():
    """Model export and the annotators import with napari, qtpy, magicgui,
    onnx and onnxruntime blocked (and the libraries above), and load no JAX:
    the card's machine has none of them."""
    code = (
        "import importlib, sys\n"
        "BLOCK = {'napari', 'qtpy', 'magicgui', 'onnx', 'onnxruntime', 'pandas', 'imageio',\n"
        "         'h5py', 'sklearn', 'matplotlib', 'xxhash', 'joblib', 'jax', 'networkx'}\n"
        "class Blocker:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCK:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Blocker())\n"
        "names = ['_model_settings', '_test_util', 'bioimageio', 'bioimageio.predictor_adaptor',\n"
        "         'bioimageio.onnx_decoder', 'bioimageio.model_export',\n"
        "         'bioimageio.bioengine_export', 'sam_annotator', 'sam_annotator._compat',\n"
        "         'sam_annotator._tooltips', 'sam_annotator.util', 'sam_annotator._state',\n"
        "         'sam_annotator._widgets', 'sam_annotator._annotator',\n"
        "         'sam_annotator.annotator_2d', 'sam_annotator.annotator_3d',\n"
        "         'sam_annotator.annotator_tracking', 'sam_annotator.image_series_annotator',\n"
        "         'sam_annotator.object_classifier', 'sam_annotator.training_ui']\n"
        "for n in names:\n"
        "    importlib.import_module('micro_sam_tpu_torch.' + n)\n"
        "from micro_sam_tpu_torch.sam_annotator import _compat\n"
        "assert not _compat.HAVE_QT\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCK\n"
        "             or m == 'micro_sam_tpu' or m.startswith('micro_sam_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "20"
