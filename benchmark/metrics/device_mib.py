"""Peak device memory allocated over set-up and window, in MiB."""


def read(rec):
    return rec["device_peak_bytes"] / 2**20
