"""Share of the profiled slice in which no kernel, copy or fill ran on the
card, in percent: 1 - the union of device intervals over the slice."""


def read(record):
    sl = record.get("slice")
    if not sl or not sl["busy_s"]:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
