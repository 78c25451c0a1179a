"""Device BAQ, seconds per call (stagetimer, summed over the window
workers): read extraction (`ingest.extract`) and the runner's K3/K4
batches with their copies (`ingest.device_baq`).  Reads nothing where the
device BAQ does not run."""


def read(rec):
    st, calls = rec["stages"], rec["calls"]
    if not calls or "ingest.device_baq" not in st:
        return None
    return (st["ingest.device_baq"] + st.get("ingest.extract", 0.0)) / calls
