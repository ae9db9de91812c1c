"""serve_p95_ms: the 95th percentile of the volumes' times, from the start
of a volume's upload to its masks in host memory, over every volume of the
run's untraced window. The loop is closed with a fixed number of volumes
in flight, so it runs at capacity and this tail follows the host's jitter;
it stands beside the rate, which carries the bound."""


def read(view):
    return view.untraced.get("serve_p95_ms")
