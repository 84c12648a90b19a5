"""The harness's general parts: files found by name, inputs made from the
seed, the measured window, the profiler trace and the result line."""
