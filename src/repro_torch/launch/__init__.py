"""Entry points of the port (src/repro/launch): the serving CLI and the
training CLI. The dry-run and the roofline tooling wait (ROADMAP.md,
Queue 1, item 8)."""
