"""Device kernels a request in the profiled stretch."""


def read(r):
    t = r.trace
    if r.kind != "gen_requests" or not t or not t["units"] or not t["kernels"]:
        return None
    return t["kernels"] / t["units"]
