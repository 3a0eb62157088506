"""The counted FLOPs of the window's requests over the window's wall seconds
times the configuration dtype's fixed peak, in % (unprofiled part of a
traced run)."""


def read(r):
    if r.kind != "gen_requests" or not r.window["units"]:
        return None
    rate = r.work["flops"] * r.window["units"] / r.window["seconds"]
    return 100.0 * rate / r.peak["flops"]
