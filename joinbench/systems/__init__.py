"""System adapters, one a kind of configuration (the configuration
file's ``"system"``). An adapter is a module with ``System(config,
traffic, ctx)``, which offers:

- ``setup(seed)``: the communicator and the inputs, on the device;
- ``rows_per_op``: the input rows of one operation, over every rank;
- ``op()``: one operation through the port's entry point;
- ``outcome(result)``: ``(failed, retries)`` of one result;
- ``keep(result)``: what of a sampled result the check needs;
- ``release()``: drop the program's state before the check;
- ``check(kept, seed)``: ``(numbers, work)``: each number compared as
  ``(value, limit)``, and the work one operation needs (the counts the
  kernel files' coefficients multiply), from the reference;
- ``control(seed)``: the reference in the program's place at a lower
  precision, in ``keep``'s form.
"""
