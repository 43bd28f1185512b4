"""The benchmark's general code: spec loading, the system adapter, the
closed-loop window, spans, trace reduction and the correctness check."""
