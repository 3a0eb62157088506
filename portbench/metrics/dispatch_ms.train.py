"""Host milliseconds inside ``train/steps.py:train_step_gather`` a step: the
span's host time over the window's steps (unprofiled part of a traced run)."""


def read(r):
    total, count = r.window["spans"].get("train_step_gather", (0.0, 0))
    if r.kind != "train_steps" or not count:
        return None
    return 1e3 * total / count
