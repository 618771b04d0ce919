"""The drivers of the benchmark's cells, one file a traffic kind: a
traffic file's `kind` names portbench/kinds/<kind>.py, whose DRIVER is the
class that runs it (portbench/cells.py::Driver says what it gives). A new
kind is a new file here; it may import and extend another kind's driver."""
