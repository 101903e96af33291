"""replay_ms: the window's wall time over the replay steps it completed, in
ms a step (a step replays the traffic's whole chain once)."""


def read(run):
    if run.entry != "replay" or run.steps == 0:
        return None
    return run.window_s / run.steps * 1e3
