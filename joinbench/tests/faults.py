"""Faults planted in the port underneath a run, for the tests that see
``correct`` come out false. Each is a function a rank process calls
before it starts (``launch.World(prepare=...)``); nothing here is
imported by a run of the benchmark."""


def _wrap_join(mutate_inputs=None, mutate_result=None):
    import distributed_join_tpu_torch.parallel.distributed_join as dj

    orig = dj.distributed_inner_join

    def faulty(build, probe, comm, **kw):
        if mutate_inputs is not None:
            build, probe = mutate_inputs(build, probe)
        res = orig(build, probe, comm, **kw)
        return res if mutate_result is None else mutate_result(res)

    dj.distributed_inner_join = faulty


def _wrap_query(mutate_inputs=None, mutate_result=None):
    import distributed_join_tpu_torch.parallel.query_exec as qe

    orig = qe.distributed_query

    def faulty(tables, plan, comm, **kw):
        if mutate_inputs is not None:
            tables = mutate_inputs(tables)
        res = orig(tables, plan, comm, **kw)
        return res if mutate_result is None else mutate_result(res)

    qe.distributed_query = faulty


def _half(table):
    from distributed_join_tpu_torch.table import Table

    v = table.valid.clone()
    v[1::2] = False
    return Table(table.columns, v)


def _alter_first(res, column):
    """Add 1 to ``column`` of the first valid row, on rank 0 only."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_rank() != 0:
        return res
    col = res.table.columns[column]
    i = int(res.table.valid.nonzero()[0, 0])
    col[i] += 1
    return res


def join_half_probe():
    """Half of the probe rows left out of every join."""
    _wrap_join(mutate_inputs=lambda b, p: (b, _half(p)))


def join_no_exchange():
    """The exchange between ranks left out: every all-to-all returns
    what it was given, so each rank joins only the rows it holds."""
    from distributed_join_tpu_torch.parallel.communicator import (
        ProcessGroupCommunicator,
    )

    ProcessGroupCommunicator.all_to_all = lambda self, x, group=None: x


def join_altered_answer():
    """One output row's probe payload altered where it is produced."""
    _wrap_join(mutate_result=lambda r: _alter_first(r, "probe_payload"))


def join_swapped_lanes():
    """The key written into the build payload's place in every output
    row, as an expand that gathers the wrong lane would write it."""
    def swap(res):
        cols = res.table.columns
        cols["build_payload"] = cols["key"].clone()
        return res

    _wrap_join(mutate_result=swap)


def query_half_lines():
    """Half of lineitem's rows left out of every query."""
    _wrap_query(mutate_inputs=lambda t: dict(t, lineitem=_half(t["lineitem"])))


def query_altered_answer():
    """One group's revenue altered where it is produced."""
    _wrap_query(mutate_result=lambda r: _alter_first(r, "revenue"))
