"""Exact confirm, seconds per call (stagetimer `confirm`, summed over the
confirm executor's threads): the candidate clusters' re-ingest with the
C BAQ, the exact DP, and the resolution of the window's lazy screen
result (its K1 dispatch and fetch) that nests in it."""


def read(rec):
    st, calls = rec["stages"], rec["calls"]
    if not calls or "confirm" not in st:
        return None
    return st["confirm"] / calls
