"""train_img_per_s: training images of every step of the window over the
window's wall time, ended by a synchronise (host clock)."""


def read(rec):
    if rec.kind != "train" or not rec.host.get("window_s"):
        return None
    return rec.host["images"] / rec.host["window_s"]
