"""A run with the timed path broken underneath comes out not correct.  Each
test skips the harness's look for a card and drives the rest of a run at a
toy size on the CPU, with the cell's own limits; the sound run beside them
comes out correct."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import serve, train
from benchmark.tests.tiny import cell, tiny_config

TRAIN_CELLS = ["srgan_full.train_b128", "singlegan_k5.train_b128"]
DEV = torch.device("cpu")


def run_train(workload, **kw):
    name = workload.split(".")[0]
    c = cell(workload, tiny_config(name), pool_batches=4, warmup_steps=1,
             **kw)
    return train.run(c, 2 ** 31 + 11, 0.5, False, DEV, time.perf_counter(),
                     None)


def run_serve(**kw):
    c = cell("srgan_full.serve_mix", tiny_config("srgan_full"),
             rate_per_s=8, sample=6, late_wait_s=20, **kw)
    return serve.run(c, 2 ** 31 + 12, 2.0, False, DEV, time.perf_counter(),
                     None)


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_sound_training_run_is_correct(workload):
    result, checks = run_train(workload)
    assert result["correct"], checks
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device"]


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_a_step_that_leaves_its_state_unchanged_fails(workload, monkeypatch):
    from srgan_tpu_torch.training.gan import GANTrainer

    real = GANTrainer.step

    def unchanged(self, state, batch, epoch=0):
        nets = (state.G, state.D, state.E)
        saved = [[p.detach().clone() for p in n.parameters()] for n in nets]
        metrics = real(self, state, batch, epoch)
        with torch.no_grad():
            for n, ps in zip(nets, saved):
                for p, v in zip(n.parameters(), ps):
                    p.copy_(v)
        return metrics

    monkeypatch.setattr(GANTrainer, "step", unchanged)
    result, checks = run_train(workload)
    assert not result["correct"]
    assert checks["change_gap"]["value"] > checks["change_gap"]["limit"]


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_half_the_batch_left_out_fails(workload, monkeypatch):
    from srgan_tpu_torch.training.gan import GANTrainer

    real = GANTrainer.step

    def half(self, state, batch, epoch=0):
        return real(self, state, {k: v[:len(v) // 2]
                                  for k, v in batch.items()}, epoch)

    monkeypatch.setattr(GANTrainer, "step", half)
    result, checks = run_train(workload)
    assert not result["correct"], checks


def test_sound_serving_run_is_correct():
    result, checks = run_serve()
    assert result["correct"], checks
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_wrong_answer_fails(fault, monkeypatch):
    from srgan_tpu_torch.serving import Translator

    real = Translator.translate

    def broken(self, images, *a, **k):
        fakes, latent = real(self, images, *a, **k)
        if fault == "altered":
            fakes = fakes.copy()
            fakes[..., 0, 0, 0] += np.float32(1.0)
            return fakes, latent
        n = max(1, len(fakes) // 2)
        return fakes[:n], latent[:n]

    monkeypatch.setattr(Translator, "translate", broken)
    result, checks = run_serve()
    assert not result["correct"], checks


def run_dp(fault=None):
    from benchmark.harness import common, dp

    c = cell("srgan_full.train_b128", tiny_config("srgan_full"),
             pool_batches=4, warmup_steps=1, rank_timeout_s=300)
    c["chips"] = 4
    common.prepare_env()
    return dp.run(c, 2 ** 31 + 13, 0.5, False, DEV, time.perf_counter(),
                  None, fault=fault)


def test_data_parallel_over_four_gloo_ranks_is_correct():
    result, checks = run_dp()
    assert result["correct"], checks
    assert result["device"]["count"] == 4


def test_the_exchange_between_ranks_left_out_fails():
    result, checks = run_dp("no_exchange")
    assert not result["correct"], checks
