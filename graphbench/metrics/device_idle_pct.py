"""Share of the traced window, as the host clock timed it, in which no
kernel or copy ran on the card: 100 * (1 - busy / window), busy being the
length of the union of the device operations' intervals.  Moves
trials_per_s."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
