"""device_idle_pct: the same reader, named apart where it moves
tts_ms.rebuild, an end-to-end time with a bound of its own."""
from portbench.harness.spec import metric_reader

read = metric_reader("device_idle_pct")
