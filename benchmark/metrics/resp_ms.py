"""resp_ms: the mean time a request spends in the RESP front end, by the
program's own spans: its ``resp.command`` (argv parsed to reply flushed)
less the reader pool's two handoffs and ``engine.ft_search``; the reply's
encode and write (``resp.write``) included."""

from benchmark import program_spans


def read(run):
    return program_spans.request_mean_ms(run, {
        "resp.command": 1, "reader.queue": -1, "engine.ft_search": -1,
        "reader.return": -1})
