"""Pileup columns of every call completed in the window over the window's
seconds (host clock): one call at a time, BAM to VCF on disk."""


def read(rec):
    if not rec["calls"] or not rec["window_s"]:
        return None
    return sum(rec["cols"]) / rec["window_s"]
