"""Disaggregated Data PreProcessing (paper §4.2): workers that materialize
base batches, trainer-side slot-based rebatching client, pipelined I/O
prefetch, a double-buffered device feed, elastic autoscaling, and
data-affinity planning."""
