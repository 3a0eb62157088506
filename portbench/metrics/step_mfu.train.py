"""The counted FLOPs of the window's steps over the window's wall seconds
times the configuration dtype's fixed peak, in % (unprofiled part of a
traced run)."""


def read(r):
    if r.kind != "train_steps" or not r.window["units"]:
        return None
    rate = r.work["flops"] * r.window["units"] / r.window["seconds"]
    return 100.0 * rate / r.peak["flops"]
