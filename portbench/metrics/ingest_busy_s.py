"""Host ingest and sweep, seconds per call (stagetimer, summed over
threads): the raw BAM fetch (`ingest.raw`, the prefetch thread) and the
window builds (`ingest_columns`, the window workers), less the device
BAQ's extraction and runs that nest in the builds (`ingest.extract`,
`ingest.device_baq`: devbaq_busy_s).  The confirm's re-ingest nests in
`confirm` (confirm_busy_s), so no second counts twice."""


def read(rec):
    st, calls = rec["stages"], rec["calls"]
    if not calls or ("ingest.raw" not in st and "ingest_columns" not in st):
        return None
    busy = (st.get("ingest.raw", 0.0) + st.get("ingest_columns", 0.0)
            - st.get("ingest.extract", 0.0) - st.get("ingest.device_baq", 0.0))
    return busy / calls
