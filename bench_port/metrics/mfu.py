"""The whole attack step's share of the card's peak: the victim's model
FLOPs of the attack iterations before the profiler's start (each
one forward and one input gradient of the batch, counted by the
configuration's ``forward_flops`` and ``input_grad_flops``; the
preparation's and the final prediction's passes not counted) over those
attack spans (host clock, each ending in a synchronise) at the
configuration's peak, in percent. The profiler and what runs after it
stay out."""


def read(run):
    seconds, iters = run.pre_trace_attack()
    if iters <= 0 or seconds <= 0:
        return None
    cfg, mod, tr = run.cell.config, run.cell.config_mod, run.cell.traffic
    per_iter = tr["batch"] * (mod.forward_flops(cfg, tr["points"])
                              + mod.input_grad_flops(cfg, tr["points"]))
    return 100.0 * per_iter * iters / (seconds * cfg["peak_flops"])
