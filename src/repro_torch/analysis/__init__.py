"""The analysis layer (the port of ``repro.analysis``): op traces of
eager calls (`optrace`, the counterpart of the reference's HLO parsing),
the H100 roofline over them (`roofline`), the findings schema
(`report`), the predict-then-probe autotuner (`autotune`) and the two
lint layers: passes over a traced train step (`lint`) and rules over
the source tree (`astlint`)."""
