"""How a traffic mix's requests reach the program: one module a driver,
named by the mix's ``driver`` key (see ``portbench.harness``)."""
