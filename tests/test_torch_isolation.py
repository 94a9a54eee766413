"""The port stands alone: it imports nothing of JAX or srgan_tpu (nor PIL
or matplotlib when a module is imported), ships no binary, and never
carries on on the CPU when CUDA is asked for."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "srgan_tpu_torch")

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, ROOT)
import srgan_tpu_torch
for m in pkgutil.walk_packages(srgan_tpu_torch.__path__, "srgan_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              ROOT + "/chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "srgan_tpu", "triton", "PIL",
                                    "matplotlib"))
ported = sorted(m for m in sys.modules if m.startswith("srgan_tpu_torch"))
print("IMPORTED", len(ported))
print("MODULES", " ".join(ported))
print("BAD", bad)
"""

# the modules of the data feed, the loop, the CLIs and the evaluation, which
# import no PIL or matplotlib either (the card's host may lack them; they
# are imported where they are used)
FEED = ("srgan_tpu_torch.data", "srgan_tpu_torch.data.attributes",
        "srgan_tpu_torch.data.dataset", "srgan_tpu_torch.data.loader",
        "srgan_tpu_torch.data.native", "srgan_tpu_torch.data.sampling",
        "srgan_tpu_torch.data.synthetic", "srgan_tpu_torch.ops.image",
        "srgan_tpu_torch.training.loop", "srgan_tpu_torch.train",
        "srgan_tpu_torch.utils.metrics",
        # classifier pretraining and PRDC evaluation
        "srgan_tpu_torch.evaluation", "srgan_tpu_torch.evaluation.features",
        "srgan_tpu_torch.evaluation.harness",
        "srgan_tpu_torch.evaluation.prdc",
        "srgan_tpu_torch.training.classifier",
        "srgan_tpu_torch.training.vgg_finetune",
        "srgan_tpu_torch.pretrain_classifier", "srgan_tpu_torch.finetune_vgg",
        "srgan_tpu_torch.evaluate_prdc",
        # visualisation (matplotlib and PIL imported where they draw) and
        # its CLIs, and the server
        "srgan_tpu_torch.utils.viz", "srgan_tpu_torch.sample_sweep",
        "srgan_tpu_torch.plot_losses", "srgan_tpu_torch.serve",
        # data parallel over torch.distributed, and the batch-norm mode's
        # layers
        "srgan_tpu_torch.parallel", "srgan_tpu_torch.parallel.mesh",
        "srgan_tpu_torch.parallel.collectives", "srgan_tpu_torch.nn.layers")


def test_port_and_chip_smoke_import_no_jax_or_srgan_tpu():
    # -I: no PYTHONPATH or site hooks that could preload anything
    r = subprocess.run(
        [sys.executable, "-I", "-c", f"ROOT = {ROOT!r}\n" + _IMPORT_ALL],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    n = int(r.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 40, r.stdout
    modules = r.stdout.split("MODULES")[1].split("\n")[0].split()
    assert set(FEED) <= set(modules), sorted(set(FEED) - set(modules))


def test_port_files_are_small_text():
    for dirpath, _, files in os.walk(PKG):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            path = os.path.join(dirpath, f)
            assert os.path.getsize(path) <= 256 * 1024, path
            with open(path, "rb") as fh:
                data = fh.read()
            assert b"\0" not in data, f"{path} is binary"
            data.decode("utf-8")


def test_cuda_wrapper_raises_here():
    from srgan_tpu_torch.ops import build, diversification, histogram, norm
    from srgan_tpu_torch.training.gan import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    x = torch.zeros(1, 2, 3, 3, device="meta")
    t = torch.zeros(1, 2, device="meta")
    g = torch.ones(2, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        norm.fused_cbinorm(x, t, g, g)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    mu = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        histogram.soft_histogram_cols(mu)
    with pytest.raises(ValueError, match="cuda"):
        diversification.fused_diversification(
            mu, torch.zeros(50, device="meta"), 4)
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build()
    assert norm.LAUNCHES == norm.BWD_LAUNCHES == 0
    assert histogram.LAUNCHES == histogram.BWD_LAUNCHES == 0
    assert diversification.LAUNCHES == 0


def test_resolve_device_turns_tf32_off_on_cuda(monkeypatch):
    """Every entry point resolves its device here: on CUDA, fp32
    convolutions and matmuls must not run in TF32 (PyTorch's default lets
    cuDNN use it); the CPU leaves the flags alone."""
    from srgan_tpu_torch.training.gan import resolve_device

    for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flags, "allow_tf32", True)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_norm_output_carries_the_gradient():
    """The norm's output keeps a grad_fn whenever an input requires grad,
    so a gradient reaches every layer below a norm."""
    from srgan_tpu_torch.ops import norm

    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    t = torch.zeros(2, 3)
    g = torch.ones(3)
    out = norm.fused_cbinorm(x, t, g, torch.zeros(3))[0]
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    y = norm.fused_instance_norm(x.detach().requires_grad_(True), relu=True)
    assert y.grad_fn is not None
    with pytest.raises(ValueError, match="cuda"):
        norm.fused_cbinorm(x.detach().to("meta").requires_grad_(True),
                           t.to("meta"), g.to("meta"),
                           torch.zeros(3, device="meta"))


@pytest.mark.parametrize("cli", ["pretrain_classifier", "finetune_vgg",
                                 "evaluate_prdc", "sample_sweep"])
def test_new_clis_refuse_cuda_without_it(tmp_path, cli):
    """Each CLI defaults to the card and, without CUDA, stops before it
    reads any data instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    args = [sys.executable, "-m", f"srgan_tpu_torch.{cli}", "--out",
            str(tmp_path / "out")]
    if cli in ("evaluate_prdc", "sample_sweep"):
        args += ["--ckpt", str(tmp_path / "ckpt"), "--preset",
                 "05_srgan_full"]
    else:
        args += ["--synthetic"]
    r = subprocess.run(args, cwd=ROOT, env=dict(os.environ,
                                                 TMPDIR=str(tmp_path)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr, r.stderr[-3000:]
    assert not os.path.exists(tmp_path / "out")
    assert not [d for d in os.listdir(tmp_path) if "synthetic" in d]
