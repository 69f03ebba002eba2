"""The reference's side of each traffic mode, one file a mode name:
`run(solver, config, traffic, inputs) -> {output name: tensor [B, ...]}`,
the outputs the harness compares with the program's of the same name."""
