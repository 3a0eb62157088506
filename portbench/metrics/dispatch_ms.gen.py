"""Host milliseconds inside ``make_generate_fn``'s ``generate`` a request: the
span's host time over the window's requests (unprofiled part of a traced run)."""


def read(r):
    total, count = r.window["spans"].get("generate", (0.0, 0))
    if r.kind != "gen_requests" or not count:
        return None
    return 1e3 * total / count
