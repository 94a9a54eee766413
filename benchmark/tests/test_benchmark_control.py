"""The controls, on the card (``-m card``): the reference computed one
precision below the configuration's (fp8 for bf16), put in the program's
place, comes out not correct against each cell's limits.  Training: the
check steps at the cell's own size; serving (the serving cell's files,
for the cell a later change adds): the run's sampled requests."""

import pytest
import torch

from benchmark.harness import common, serve, train
from benchmark.tests.tiny import cell

pytestmark = pytest.mark.card


@pytest.mark.parametrize("workload", ["srgan_full.train_b128",
                                      "singlegan_k5.train_b128"])
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102])
def test_training_control_fails(workload, seed, cuda_device):
    c = common.resolve_cell(workload)
    ref = train.reference_check(c["config"], c["traffic"], seed, cuda_device)
    ctl = train.reference_check(c["config"], c["traffic"], seed, cuda_device,
                                "fp8")
    ok, checks = common.judge(train.compare(ctl, ref), c["limits"])
    torch.cuda.empty_cache()
    assert not ok, checks


@pytest.mark.parametrize("seed", [2 ** 31 + 103, 2 ** 31 + 104])
def test_serving_control_fails(seed, cuda_device):
    c = cell("srgan_full.serve_mix", common.load_json(
        common.BENCH_DIR / "configs" / "srgan_full.json"))
    _, reqs = serve.sampled_requests(c["config"], c["traffic"], seed,
                                     common.manifest()["run_seconds"])
    ref = serve.reference_outputs(c["config"], seed, reqs, cuda_device)
    ctl = serve.reference_outputs(c["config"], seed, reqs, cuda_device, "fp8")
    paths = [r["path"] for r in reqs]
    answers = [{"mu": a, "logvar": b} if p == "/encode"
               else {"fakes": a, "latent": b} for (a, b), p in zip(ctl, paths)]
    numbers = serve.gaps(answers, ref, paths)
    numbers.update(failed_requests=0, unanswered_samples=0)
    ok, checks = common.judge(numbers, c["limits"])
    assert not ok, checks
