"""The least time of the profiled stretch's counted work, max(FLOPs / peak,
bytes / peak bandwidth) a step times its steps, over the device's busy
time in the stretch, in %."""


def read(r):
    t = r.trace
    if r.kind != "train_steps" or not t or not t["units"] or t["busy_s"] <= 0:
        return None
    least = max(r.work["flops"] / r.peak["flops"], r.work["bytes"] / r.peak["bytes"])
    return 100.0 * least * t["units"] / t["busy_s"]
