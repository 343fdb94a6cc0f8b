"""anatomask_torch and chip_smoke.py stand alone: they import torch, never JAX
or anything of the JAX package."""
import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import anatomask_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "anatomask_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(anatomask_torch.__path__,
                                                         "anatomask_torch."))


def _sources():
    return sorted((ROOT / "anatomask_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax():
    code = (
        "import importlib, json, sys\n"
        f"for name in {['anatomask_torch', *_modules()]!r}:\n"
        "    importlib.import_module(name)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_package_has_the_mirrored_modules():
    names = set(_modules())
    for mod in ("models.layers", "models.stunet", "models.build", "ops.conv3x3",
                "ops.moments", "ops._build", "convert", "device", "ssl.sparse",
                "ssl.decoder", "ssl.spark", "ssl.anatomask", "ssl.ema", "ssl.pretrain",
                "ssl.mednext",
                "plans.plans_handler", "plans.label_handling", "training.checkpoint",
                "inference.gaussian", "inference.sliding_window", "inference.predictor",
                "ops.zslab_conv", "paths", "configuration", "utils.helpers",
                "preprocessing.preprocessor", "data.dataset", "data.sampler",
                "data.pipeline", "data.device_cache", "data.augment",
                "training.schedules", "training.trainer", "models.plain_unet",
                "inference.export", "preprocessing.cropping", "preprocessing.normalization",
                "preprocessing.resampling", "imageio.base", "imageio.nifti",
                "imageio.numpy_io", "imageio.meta_image", "imageio.natural_image",
                "imageio.tiff_io", "imageio.minc_io", "imageio.registry",
                "training.losses", "training.logger", "evaluation.metrics",
                "planning.topology", "planning.fingerprint", "planning.verify_integrity",
                "planning.planner", "planning.move_plans", "postprocessing.components",
                "ensembling.ensemble", "evaluation.find_best_configuration",
                "utils.model_sharing", "dataset_conversion.generate_dataset_json", "cli"):
        assert f"anatomask_torch.{mod}" in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            roots = [a.value.split(".")[0] for a in node.args[:1] if isinstance(a, ast.Constant)]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), f"{path}:{node.lineno} imports {roots}"
