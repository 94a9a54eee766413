"""The plain reference against the program at a toy size on the CPU (one
training step, one served request), and the work counts: the meta device's
against a real pass, and the norm's least times against the program's
earlier arithmetic."""

import numpy as np
import pytest
import torch

from benchmark.harness import common, mix, serve, train
from benchmark.reference import counts
from benchmark.tests.tiny import tiny_config


@pytest.mark.parametrize("name", ["srgan_full", "singlegan_k5"])
def test_one_training_step_matches(name):
    config = tiny_config(name)
    traffic = {"pool_batches": 1, "check_steps": 1}
    dev = torch.device("cpu")
    prog = train.Program(config, 5, dev)
    pool = train.make_pool(config, traffic, 5, dev)
    rec = train.record_check(prog.step, prog.nets, prog.opts, pool, 1, dev)
    ref = train.reference_check(config, traffic, 5, dev)
    got = train.compare(rec, ref)
    # fp32 on both sides: rounding; the worst leaf's moment takes phase
    # 2's L1 on nearly equal encoder outputs, whose sign rounding flips
    assert got["loss_gap"] < 1e-4
    assert got["grad_gap_median"] < 1e-4
    assert got["change_gap"] < 1e-3
    assert got["grad_gap"] < 1e-2


def test_one_served_request_matches():
    from srgan_tpu_torch.serving import handle_request

    config = tiny_config("srgan_full")
    traffic = common.load_json(common.BENCH_DIR / "traffic"
                               / "serve_mix.json")
    dev = torch.device("cpu")
    bodies = mix.pool(dict(traffic, pool_per_kind={k: 2 for k in
                                                   traffic["pool_per_kind"]}),
                      config["model"], 3)
    reqs = [b for kind in bodies.values() for b in kind]
    server, tr = serve.build_server(config, dict(traffic,
                                                 warm_batch_sizes=[1]),
                                    3, dev, None)
    server.server_close()
    answers = []
    for r in reqs:
        status, data = handle_request(
            tr, r["path"], mix.encode_npz({k: v for k, v in r.items()
                                           if k != "path"}))
        assert status == 200
        answers.append(mix.decode_npz(data))
    got = serve.gaps(answers, serve.reference_outputs(config, 3, reqs, dev),
                     [r["path"] for r in reqs])
    assert got["fake_gap"] < 1e-4 and got["code_gap"] < 1e-4
    assert got["latent_gap"] == 0.0


@pytest.mark.parametrize("name", ["srgan_full", "singlegan_k5"])
def test_work_counts_on_meta_equal_a_real_pass(name):
    config = tiny_config(name, "bfloat16", batch=4)
    meta, real = counts.train_step_work(config), \
        counts.train_step_work(config, "cpu")
    assert meta == real
    assert meta["flops"] > 0 and meta["norm_fwd"] > meta["norm_bwd"] > 0


def test_full_size_counts():
    """The flagship's step: 415.4 GFLOP an image (the program's own
    ATen-level count was 415.74 with the trunk frozen) and 17.53 ms of norm
    bounds in bf16 (9.59 forward + 7.94 backward by the program's launch
    shapes)."""
    config = common.load_json(common.BENCH_DIR / "configs"
                              / "srgan_full.json")
    w = counts.train_step_work(config)
    assert w["flops"] / 128 / 1e9 == pytest.approx(415.44, rel=1e-3)
    assert w["norm_bound_ms"] == pytest.approx(17.53, rel=1e-3)


@pytest.mark.parametrize("shape,fwd,bwd", [
    ((128, 64, 128, 128, 4), 0.3205494447761194, 0.4808193528358209),
    ((128, 256, 32, 32, 2), 0.04018298268656716, 0.060255216716417904),
    ((256, 64, 128, 128, 2), 0.32057878925373134, 0.48085847880597016),
    ((1, 3, 7, 5, 4), 2.686567164179104e-07, 4.047761194029851e-07),
])
def test_norm_bounds_are_the_programs_earlier_arithmetic(shape, fwd, bwd):
    # the values chip_smoke.py's bound_ms and bwd_bound_ms give
    assert counts.bound_ms(*shape) == fwd
    assert counts.bwd_bound_ms(*shape) == bwd


def test_fp8_control_rounds():
    from benchmark.reference.nets import fake_fp8

    x = torch.linspace(-3, 3, 1001)
    y = fake_fp8(x, torch.float8_e4m3fn)
    err = (y - x).abs().max().item()
    assert 1e-3 < err < 0.2
    assert np.isclose(y.abs().max().item(), 3.0)
