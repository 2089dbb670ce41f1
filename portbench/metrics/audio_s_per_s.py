"""audio_s_per_s: audio-seconds of input whose features were complete on the
device by the end of the measured window, over the window's wall time (the
window ends with a synchronize). All work over all the time."""


def read(ctx):
    win = ctx.window
    if win.wall_s <= 0 or win.steps == 0:
        return None
    return win.audio_s / win.wall_s
