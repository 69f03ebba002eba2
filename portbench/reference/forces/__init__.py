"""Force closures of the reference, one file each."""
