"""Core API tour: tasks, objects, actors (run: python
examples_torch/01_core_api.py; it touches no device, so ``--device cpu``
changes nothing).

The port ships functions and classes to its workers by import path, so
they are defined at module level and the work runs under
``if __name__ == "__main__":`` (a worker imports this file to find them).
"""
import argparse

import ray_tpu_torch as rt


@rt.remote
def square(x):
    return x * x


@rt.remote
class Counter:
    def __init__(self):
        self.n = 0

    def add(self, k=1):
        self.n += k
        return self.n


@rt.remote
def total(xs):
    return sum(xs)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None)
    parser.parse_args()
    rt.init(num_cpus=8)  # explicit size: actors HOLD their CPU, so
    # leave headroom for tasks scheduled alongside them

    # tasks fan out; refs compose (square-of-square without fetching)
    refs = [square.remote(i) for i in range(8)]
    print("squares:", rt.get(refs))
    print("chained:", rt.get(square.remote(refs[3])))

    # objects: put once, share by reference with tasks
    big = rt.put(list(range(10_000)))
    print("sum(big):", rt.get(total.remote(big)))   # the REF travels
    print("fractional cpu:", rt.get(square.options(num_cpus=0.5).remote(3)))

    # actors: stateful, ordered
    c = Counter.remote()
    for _ in range(5):
        c.add.remote()
    print("count:", rt.get(c.add.remote(0)))

    ready, pending = rt.wait([square.remote(2), square.remote(3)],
                             num_returns=1)
    print("first ready:", rt.get(ready[0]))
    rt.shutdown()


if __name__ == "__main__":
    main()
