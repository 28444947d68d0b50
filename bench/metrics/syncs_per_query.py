"""Front door and executor: device-to-host fetches a query
(``ExecStats.pipeline_syncs``)."""


def read(run):
    s = run["pipeline_syncs"]
    return sum(s) / len(s) if s else None
