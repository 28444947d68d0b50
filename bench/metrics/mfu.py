"""Model step: the FLOPs the window's served requests need
(``flops.model_flops``: prompt tokens, served tokens, 8 of 64 experts
for a mixture) over the traced window's time at the H100's dense
tensor-core peak, in %."""
from bench import flops, peaks
from bench.ref import tokenizer as tk


def read(run):
    tr = run["trace"]
    if not tr or not run["requests"]:
        return None
    cfg, eng = run["config"], run["config"]["engine"]
    reqs = [(len(tk.prompt_tokens(p, eng["max_seq"], cfg["vocab_size"])),
             len(ids)) for p, ids in run["requests"]]
    return 100 * flops.model_flops(cfg, reqs) / (
        tr["window_s"] * peaks.DENSE_TENSOR_FLOPS)
