"""Fine pixels an availability call works, in millions: the program's
counter ``availability_matrix_device.window_pixels`` (the pixels of the
shapes' windows) over the calls that read it; None where the program has
no such counter."""


def read(run):
    meta = [m for m in run.meta.values() if m["entry"] == "avail" and m.get("counted")]
    if not meta:
        return None
    return sum(m["window_pixels"] for m in meta) / sum(m["counted"] for m in meta) / 1e6
