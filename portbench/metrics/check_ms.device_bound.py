"""check_ms: the same reader, named apart where it moves
tts_ms.device_bound, an end-to-end time with a bound of its own."""
from portbench.harness.spec import metric_reader

read = metric_reader("check_ms")
