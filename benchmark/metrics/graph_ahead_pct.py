"""Share of the CUDA graph replays in the traced segment that were launched
before the host read the previous iteration's column: 100 x graph_ahead /
graph_replays, the program's always-on counters (`utils/profiling.py`)
over that segment.  Nothing where no graph was replayed."""

UNIT, SOURCE = "%", "program_counter"
LAYER = "GMRES (solvers/gmres.py)"
MOVES = "step_ms_p95"


def read(r):
    replays = r.counters.get("graph_replays")
    if not replays:
        return None
    return 100.0 * r.counters["graph_ahead"] / replays
