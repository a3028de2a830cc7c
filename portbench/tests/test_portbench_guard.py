"""The refusals: a loaded JAX or JAX package, and a machine with no card;
and the reference's imports."""
import ast
import subprocess
import sys

import pytest

from portbench.harness import HERE, ROOT, forbidden_modules


def test_guard_catches_a_planted_jax_by_its_top_level_name():
    planted = {"jax": object(), "jax.numpy": object(), "benlsip_tpu_torch": object(), "torch": object()}
    assert forbidden_modules(planted) == ["jax"]
    assert forbidden_modules({"benlsip_tpu_torch.batch.refine": 0, "jaxtyping": 0, "flaxen": 0}) == []
    assert forbidden_modules({"benlsip_tpu.ops.qr": 0, "jaxlib.xla_client": 0}) == ["benlsip_tpu", "jaxlib"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "densequad-b64-fused",
                           "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


FORBIDDEN_IMPORTS = {"jax", "jaxlib", "flax", "benlsip_tpu", "benlsip_tpu_torch"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_neither_jax_nor_either_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level <= 1, f"{path.name} imports from outside reference/"
            tops = [(node.module or "").split(".")[0]] if node.level == 0 else []
        else:
            continue
        assert not set(tops) & FORBIDDEN_IMPORTS, f"{path.name}: {tops}"
