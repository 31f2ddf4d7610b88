"""One runner a kind of traffic (a mix's ``kind``): ``run(Run) ->
Outcome``."""
