"""k1_roofline.reuse: the replay kernel K1's share of its roofline, in %.

The bound of each replay is the numeric phase's work on the fixed structure
that any implementation must do (``pb_yardstick.numeric_phase_work``: A's
and B's structure and values read once, C's structure read once, C's values
written once, two flops a product) at the H100's peaks; the share is the sum
of the bounds of the window's replays over K1's device time in the window
(its tile kernel and ``replay_ends``). Where K2 also ran, the two share
``replay_ends`` and nothing is read."""

import pb_yardstick


def is_k1(name: str) -> bool:
    return "segsum_reuse" in name or "replay_ends" in name


def read(run):
    if run.trace is None or run.entry != "replay":
        return None
    if any("lp_reuse" in n for n in run.trace.kernel_names()):
        return None
    k1_s = run.trace.kernel_s(is_k1)
    if k1_s == 0:
        return None
    bound = sum(count * pb_yardstick.bound_s(nbytes, flops)[0]
                for count, nbytes, flops in run.work.values())
    return 100.0 * bound / k1_s
