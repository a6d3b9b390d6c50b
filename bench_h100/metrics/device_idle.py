"""Device: the share of the profiled frames' wall in which no kernel,
copy or fill ran on the card (1 - device-busy union / wall), in percent."""


def read(run):
    t = run["trace"]
    if not t["window_s"] or t["busy_s"] is None or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
