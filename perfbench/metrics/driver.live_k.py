"""The adaptive chunk driver's live rebuild cadence K at the window's end
(``runner.live["k"]``): 8 where the speed certificate holds, 4 where it
fell back."""


def read(ctx):
    return None if ctx.live_k is None else float(ctx.live_k)
