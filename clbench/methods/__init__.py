"""Each method's rule set-up on the program's side, one file a method,
found by the method's name in a traffic file. A file gives:

- ``TEACHER``: whether the rule needs a frozen teacher, whose weights the
  harness draws from the seed and hands to both sides;
- ``EXTRA_FORWARDS``: the backbone forwards a train image costs beyond its
  own forward and backward (the count of operations uses it);
- ``program_rule()``: the program's update rule;
- ``program_state(rule, ctx, hyper, teacher)``: its method state."""
