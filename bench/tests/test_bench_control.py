"""The control on the card: each cell at its own size for one pass (the
window a test run can hold), the program's numbers within their limits
and the control's (the reference in TF32 in the program's place)
beyond the limit of ``kv_err``. ``bench/control.py`` reads the same
over many seeds; ``PERF.md`` gives the readings."""
import pytest
import torch

from bench import check, harness, manifest


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["semsql.starcoder2-3b",
                                      "semsql.olmoe-1b-7b"])
def test_the_control_fails_where_the_program_holds(card, workload):
    cell = manifest.cell(manifest.manifest(), workload)
    cfg = cell.config
    ref = manifest.reference(cfg["family"])
    seed = 2**31 + 99
    ses = harness.session(cell, seed, 0.0, False, card)
    checks = check.judge(ref, cfg, ses.work, ses.passes, ses.warm,
                         ses.params, seed, ses.steps)
    for name, value, op, limit in checks:
        if name != "tokens_checked":  # one pass samples fewer steps
            assert check.holds(value, op, limit), (name, value, limit)
    low = check.replay(ref, cfg, ses.params, ses.steps, tf32=True)
    assert low["kv_err"] > cfg["limits"]["kv_err"]
