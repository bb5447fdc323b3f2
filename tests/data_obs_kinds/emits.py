# A source file for tests/test_torch_obs.py: one emit call site whose
# kind the schema does not declare.
def emit_it(sink):
    sink.emit("bogus", x=1)
