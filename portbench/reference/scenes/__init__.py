"""The reference's scene functions, one file a scene name of the
configuration files, each `build(args, dtype, device) -> Scene`."""
