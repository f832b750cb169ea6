"""The PyTorch port stands alone: no module of `paddle_tpu_torch/` and
not `chip_smoke.py` imports JAX or the JAX package, importing the port
loads no JAX, its entry points refuse to fall back to the CPU on their
own, and the chip smoke fails without a card."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, paddle_tpu_torch.models.serving, "
            "paddle_tpu_torch.models.convert, paddle_tpu_torch.ops._build, "
            "paddle_tpu_torch.recipes.llama_pretrain, "
            "paddle_tpu_torch.recipes.ernie_4d, "
            "paddle_tpu_torch.recipes.dit_train, "
            "paddle_tpu_torch.tools.profile_train, "
            "paddle_tpu_torch.framework.io, "
            "paddle_tpu_torch.distributed.fleet.elastic, "
            "paddle_tpu_torch.distributed.checkpoint.__main__, "
            "paddle_tpu_torch.distributed.fleet.utils, "
            "paddle_tpu_torch.io, paddle_tpu_torch.text.bpe, "
            "paddle_tpu_torch._native, paddle_tpu_torch.optimizer.lr;"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_entry_points_raise_without_cuda():
    _no_card()
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(LlamaConfig.tiny())
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(model)
    from paddle_tpu_torch.models.dit import DiT, DiTConfig
    from paddle_tpu_torch.models.ernie import (
        ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification)
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    for build, cfg in ((GPTForCausalLM, GPTConfig.tiny()),
                       (ErnieForPretraining, ErnieConfig.tiny()),
                       (ErnieForSequenceClassification, ErnieConfig.tiny()),
                       (DiT, DiTConfig.tiny())):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(cfg)
        assert build(cfg, device="cpu").training


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    _no_card()
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       capture_output=True, text=True, timeout=120,
                       env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
