"""Operations and bytes of each op family, from its shapes alone: the same
whatever implements the op, so a change of implementation never moves the
yardstick.  ``least_s`` of a call is the larger of its bytes over the
memory rate and its operations over the rate of its type (``peaks``)."""
