"""The serving layer of the PyTorch port (``distributed_join_tpu/service``'s
counterpart): the warm path that keeps built join programs and resident
tables between requests.

- :mod:`.programs`: :class:`~.programs.JoinProgramCache`, built join
  programs keyed by a canonical :class:`~.programs.JoinSignature`, with
  the disk tier (``persist_dir``): one entry a program, binding its
  signature, backend and kernel digests, so a restarted daemon or a
  replacement replica binds it with no new trace;
- :mod:`.batching`: micro-batching of small joins into one padded step;
- :mod:`.resident`: :class:`~.resident.ResidentTableRegistry`, build
  tables registered once and served by probe-only programs, maintained
  LSM-style from appended deltas under a generation stamp;
- :mod:`.server`: :class:`~.server.JoinService` and its line-JSON TCP
  daemon (``python -m distributed_join_tpu_torch.service.server``);
- :mod:`.fleet`: the serving fleet (``python -m
  distributed_join_tpu_torch.service.fleet``): a signature-affinity
  router over N daemon replicas (one a card on a machine of several),
  with health-probed drain and replace, bounded failover, admission and
  per-tenant quotas, the autoscaler, K-replica resident tables with
  generation fencing and manifest rebuilds, and router HA over a fenced
  lease, so that the failure domain is one replica, not the service.

``server`` and ``fleet`` are not imported here: they are ``python -m``
entry points, and importing them from the package would run them twice
under runpy.
"""
