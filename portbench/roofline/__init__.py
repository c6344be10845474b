"""The benchmark's yardstick for work: peaks of the chips, and the
operations and bytes that each piece of work needs, as formulas over
shapes.  They count what the inputs need, whatever kernel computes it."""
