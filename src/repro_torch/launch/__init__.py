"""Entry points of the port (src/repro/launch): the serving CLI so far.
The training CLI, the dry-run and the roofline tooling wait (ROADMAP.md,
Queue 1, item 8)."""
