"""Device-busy milliseconds of the profiled calls over their outer
iterations (busy: the union of kernel, memcpy and memset intervals)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("nits"):
        return None
    return prof["busy_s"] * 1e3 / prof["nits"]
