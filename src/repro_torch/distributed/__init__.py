"""Distribution of the port's models over a torch ``DeviceMesh``: the
sharding rules (``sharding``) and the hints the models give a DTensor
step (``hints``)."""
