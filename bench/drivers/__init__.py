"""One module per kind of call a cell times, named by its traffic file's
`driver`. Each has `run(ctx) -> harness.Outcome`."""
