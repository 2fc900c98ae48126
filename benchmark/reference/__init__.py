"""The benchmark's plain reference: plain PyTorch and NumPy, written from
the configuration's equations and frozen here, so that a change to the
program cannot move what it is judged against.

It imports nothing of the program: `step` is one F-16 control-task step
(reset select with its draws, actuator lag, aero surrogate, nlplant, Euler,
task layer, sensor noise), `philox` the counter-based generator the step
kernel draws from, `policy` the GRU actor-critic, the PPO loss and Adam.
The aero surrogates' weights are read from the raw npz files the
configuration names, as the program reads them.
"""
