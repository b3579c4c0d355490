"""CPU tests of the benchmark's harness (``python -m pytest -q
perfbench/tests``).  A test that needs the card decides so in a fixture
and skips without one."""
