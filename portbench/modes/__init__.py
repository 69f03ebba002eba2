"""The program's side of each traffic mode, one file a mode name, each with a
Runner(config, traffic, device): nr, units_per_call,
inner_steps (the chord steps of one split pass),
call(inputs) -> {output: tensor [B, ...]}, finite(outputs) -> share of
finite lanes (reads it back), split(inputs, around_inner) -> ms by phase."""
