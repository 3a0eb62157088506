"""1 minus the union of device operations over the profiled stretch's wall
time, in %."""


def read(r):
    t = r.trace
    if r.kind != "train_steps" or not t or not t["kernels"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
