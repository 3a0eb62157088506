"""Device kernels a step in the profiled stretch."""


def read(r):
    t = r.trace
    if r.kind != "train_steps" or not t or not t["units"] or not t["kernels"]:
        return None
    return t["kernels"] / t["units"]
