"""The benchmark's plain reference of a pod of PayloadPark pipes.

Plain PyTorch (and NumPy for the Maglev table), with nothing imported from
the program under test: the harness hands the same traces to both sides and
this package works the switch, the NF chain and the merged packets out
again from them.
"""
