"""Traffic: the open-loop arrival schedule, the seeded frames, the
client half of the serving wire protocol, and the client process that
offers the load.  Numpy and the standard library only: nothing here
imports torch or the program."""
