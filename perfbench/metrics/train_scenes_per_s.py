"""train_scenes_per_s: scenes of every step completed in the window over
the time to the last step boundary (each unit ends in its read-back)."""


def read(r):
    if r.window.seconds <= 0:
        return None
    return r.window.total("scenes") / r.window.seconds
