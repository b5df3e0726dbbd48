"""eval_scenes_per_s: val scenes through the captioning eval over the
window's time (each unit is a whole pass, its metrics computed)."""


def read(r):
    if r.window.seconds <= 0:
        return None
    return r.window.total("scenes") / r.window.seconds
