"""Seeded violations for the torch_purity pass (parsed, never imported:
``triton`` need not be installed).

Expected findings (the reference's fixture's cases keep their names):
- side-effect        print in impure_print(); print in the Triton
                     kernel() that run_kernel() launches as
                     kernel[grid](...); global in bump()
- host-sync          np.asarray and .item() in host_pull(); .cpu() and
                     .nonzero() in captured() (a torch.cuda.graph
                     region); torch.cuda.synchronize and torch.unique in
                     compiled(); .tolist() in helper(), reached from
                     uses_helper() through a call
- nondeterminism     random.random and time.time in nondet();
                     torch.rand in draws() (torch.randn with generator= is
                     the negative control)
- unhashable-static  list default of bad_static(); list literal at the
                     caller() call site (dyn()'s dynamic ``toks`` is the
                     negative control)
- build-per-call     torch's compile built inside the loop of loop_jit();
                     instrument of a local def invoked in the same scope in
                     per_call_closure(); a compiled local def called in
                     per_call_decorated(); ctypes.CDLL inside the loop of
                     load_per_item() (jit_factory(), which RETURNS the
                     wrapper, is the negative control)
"""

import ctypes
import functools
import random
import time

import numpy as np
import torch
import triton
import triton.language as tl

from ray_tpu_torch.telemetry import device as devtel

COUNT = 0


@devtel.instrument
def impure_print(x):
    print("stepping", x)
    return x + 1


@functools.partial(devtel.instrument, name="fx.host_pull")
def host_pull(x, block=(8, 8)):
    y = np.asarray(x)
    return torch.as_tensor(y).sum() + x.sum().item()


def nondet(x):
    return x * random.random() + time.time()


nondet = devtel.instrument(nondet, name="fx.nondet")


def bad_static(x, cfg=[1, 2]):
    return x


bad_static = devtel.instrument(bad_static, name="fx.bad_static")


def caller(x):
    return bad_static(x, cfg=[3, 4])


def dyn(x, toks=[]):
    return x


dyn = devtel.instrument(dyn, name="fx.dyn", dynamic_argnames=("toks",))


def dyn_caller(x):
    return dyn(x, toks=[1, 2])


@triton.jit
def kernel(x_ptr, o_ptr, BLOCK: tl.constexpr):
    print("side effect")
    offs = tl.arange(0, BLOCK)
    tl.store(o_ptr + offs, tl.load(x_ptr + offs))


def run_kernel(x):
    o = torch.empty_like(x)
    kernel[(1,)](x, o, BLOCK=x.numel())
    return o


@devtel.instrument
def bump(x):
    global COUNT
    COUNT += 1
    return x


@devtel.instrument
def draws(x, gen):
    noise = torch.rand(x.shape)
    fine = torch.randn(x.shape, generator=gen)
    return x + noise + fine


def captured(x, static_out):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        static_out.copy_(x.cpu())
        idx = x.nonzero()
    return g, idx


@torch.compile
def compiled(x):
    torch.cuda.synchronize()
    return torch.unique(x)


def helper(x):
    return x.tolist()


@devtel.instrument
def uses_helper(x):
    return helper(x)


def clean(x):
    # not hot: nothing here should be flagged
    print("host side is fine")
    return np.asarray(x).tolist(), torch.rand(3), x.item()


def loop_jit(xs):
    out = []
    for x in xs:
        g = torch.compile(lambda v: v + 1)
        out.append(g(x))
    return out


def per_call_closure(x):
    def inner(v):
        return v * 2

    f = devtel.instrument(inner, name="fx.inner")
    return f(x)


def per_call_decorated(x):
    @torch.compile
    def inner2(v):
        return v - 1

    return inner2(x)


def load_per_item(paths):
    libs = []
    for p in paths:
        libs.append(ctypes.CDLL(p))
    return libs


def jit_factory(scale):
    # negative control: the wrapper is returned, so the program outlives
    # this scope (a legitimate factory)
    def inner(v):
        return v * scale

    return devtel.instrument(inner, name="fx.factory")
