"""Reference recipes that portbench/reference/config.py does not hold, one
file each: <name>.py defines get_config(), which returns the reference's
Config of the port's recipe `name` (cells.reference_config finds it by the
traffic file's `recipe`). It builds on config.py's recipes and dataclasses
and imports nothing of the port."""
